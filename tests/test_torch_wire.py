"""Requests cross between the packages on the wire unchanged: the port's
decoded DAG has the reference's ``plan_key()`` and ``class_key()``, and
re-encodes to the same dict."""

import pytest

from tikv_tpu.server import wire
from tikv_tpu.testing.dag import DagSelect
from tikv_tpu.testing.fixture import int_table

from tikv_tpu_torch.copr import wire as pwire
from tikv_tpu_torch.convert import dag_from_wire


def _dags():
    t = int_table(3, table_id=77)

    def sel():
        return DagSelect.from_table(t, ["id", "c0", "c1", "c2"])

    out = {}
    s = sel()
    out["config3"] = s.aggregate([], [("sum", s.col("c1")),
                                      ("count_star", None),
                                      ("avg", s.col("c1"))]).build()
    s = sel()
    out["config4"] = s.aggregate([s.col("c0")], [
        ("count_star", None), ("sum", s.col("c1"))]).build()
    s = sel()
    out["selection_const_beyond_int32"] = s.where(
        s.col("c1") < 2**40, s.col("c2").is_null().not_()).aggregate(
        [s.col("c0") + 1], [("count", s.col("c1")),
                            ("avg", s.col("c2") * 3)]).build(start_ts=9)
    s = sel()
    out["float_const_output_offsets"] = s.where(
        s.col("c1") > 2.5).aggregate(
        [], [("count_star", None), ("sum", s.col("c0"))]) \
        .output_offsets([1, 0]).build()
    s = sel()
    out["logic_and_min"] = s.where(
        (s.col("c0") > 3).and_(s.col("c1").ne(7))).aggregate(
        [s.col("c2")], [("min", s.col("c1"))]).build()
    s = sel()
    out["topn"] = s.order_by(s.col("c1"), desc=True, limit=5).build()
    return out


DAGS = _dags()


@pytest.mark.parametrize("name", sorted(DAGS))
def test_plan_key_survives_the_wire(name):
    dag = DAGS[name]
    port_dag = dag_from_wire(wire.enc_dag(dag))
    assert port_dag.plan_key() == dag.plan_key()
    assert port_dag.class_key() == dag.class_key()
    assert pwire.enc_dag(port_dag) == wire.enc_dag(dag)
    assert wire.dec_dag(pwire.enc_dag(port_dag)) == dag
