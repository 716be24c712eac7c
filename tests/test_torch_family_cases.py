"""The JAX package's truth tables of the expression families, held against
the port.

``tests/test_expr_families.py``, ``tests/test_decimal.py`` and
``tests/test_collation_enum.py`` state each case as an input and the
answer MySQL gives; the reference passes them in those files.  Here each
file's source is loaded with its imports pointed at ``tikv_tpu_torch``
(the server's plan codec at the port's ``copr/wire.py``), and every case
runs against the port: the same inputs must give the same answers.

Two cases are left out, with the code they test:
``test_decimal_wire_roundtrip`` (the server's msgpack RPC body codec, which
the port does not have) and ``test_registry_size`` (the reference's
registry size; ``test_torch_expr_families.py`` holds the port's registry
to the reference's sig by sig).
"""

import pathlib
import types

import pytest

_HERE = pathlib.Path(__file__).parent
SOURCES = ("test_expr_families", "test_decimal", "test_collation_enum")
LEFT_OUT = {("test_decimal", "test_decimal_wire_roundtrip"),
            ("test_expr_families", "test_registry_size")}
# (the reference's import, the port's) before the package rename
_IMPORTS = (("from tikv_tpu.server.wire import", "from tikv_tpu.copr.wire import"),)


def _ported(name: str) -> types.ModuleType:
    src = (_HERE / f"{name}.py").read_text()
    for ref, port in _IMPORTS:
        src = src.replace(ref, port)
    src = src.replace("from tikv_tpu.", "from tikv_tpu_torch.") \
        .replace("from tikv_tpu import", "from tikv_tpu_torch import")
    assert "tikv_tpu." not in src.replace("tikv_tpu_torch.", ""), name
    mod = types.ModuleType(f"ported_{name}")
    mod.__file__ = str(_HERE / f"{name}.py")
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    return mod


_MODULES = {name: _ported(name) for name in SOURCES}
CASES = [(m, fn) for m, mod in _MODULES.items() for fn in sorted(vars(mod))
         if fn.startswith("test_") and callable(getattr(mod, fn))
         and (m, fn) not in LEFT_OUT]


@pytest.mark.parametrize("module,case", CASES,
                         ids=[f"{m}::{fn}" for m, fn in CASES])
def test_reference_case_on_port(module, case):
    getattr(_MODULES[module], case)()
