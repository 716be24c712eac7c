"""Time ``sel_compact`` and ``join_index`` at their main path's shapes in
the checkout this runs from, for an A/B comparison of two checkouts on
one card.

Run it from the root of each checkout in one session on the card,
alternating (A, B, B, A), so both see the same card and host:

    python3 ab_kernels.py A    # in checkout A
    python3 ab_kernels.py B    # in checkout B

It builds what it launches (``tikv_tpu_torch/_build/``) and prints one
line, ``AB {json}``: ``sel_compact`` at config 2s's 1% (index mode) and
0.1% (planes mode, three int32 planes) queued behind a device sleep
(``chip_smoke.cuda_ms``); ``join_index`` over config 7's build keys (2^20
distinct keys, all valid) as issued and, where its wrapper does not wait
for the card, queued; ``join_build`` and ``torch.searchsorted`` of the
span as issued.  A checkout whose ``join_build`` returns three tensors
has a ``join_index(sk, prefix)`` that reads its key range back; one that
returns four hands the key range on as the fourth.  Needs one CUDA card.
"""

import json
import sys

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from tikv_tpu_torch.device import join_probe as jp  # noqa: E402
from tikv_tpu_torch.device import selection as sm  # noqa: E402
from tikv_tpu_torch.device import sort as srt  # noqa: E402
from tikv_tpu_torch.testing import configs as cf  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_kernels: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    out = {"checkout": sys.argv[1] if len(sys.argv) > 1 else "."}
    _table, snap = cf.build_table(cs.SWEEP_ROWS)
    n = cs.SWEEP_ROWS
    planes = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
        snap.handles, snap.columns[2].values, snap.columns[3].values)]
    v = planes[2]
    for point, here in (("1%", []), ("0.1%", planes)):
        pred = v > cf.sweep_threshold(snap, cf.SWEEP[point])
        mout = sm.sel_mask(pred, n)
        k = int(mout.count)
        cap = sm.index_capacity(k * 1.5 + 64, n)
        out[f"sel_compact {point} k={k} k_cap={cap} ms"] = cs.cuda_ms(
            lambda: sm.sel_compact(mout, cap, here), 200, queued=True)
    nb = 1 << 20
    g = torch.Generator(device=dev).manual_seed(7)
    bk = torch.randperm(nb, device=dev, generator=g)
    bvalid = torch.ones(nb, dtype=torch.bool, device=dev)
    built = srt.join_build(bk, bvalid, nb)
    args = (built[0], built[2]) + tuple(built[3:])
    assert jp.join_index(*args) is not None
    out["join_index issued ms"] = cs.cuda_ms(lambda: jp.join_index(*args),
                                             50)
    if len(built) > 3:
        out["join_index queued ms"] = cs.cuda_ms(
            lambda: jp.join_index(*args), 50, queued=True)
    out["join_build issued ms"] = cs.cuda_ms(
        lambda: srt.join_build(bk, bvalid, nb), 20)
    sk = built[0]
    out["searchsorted issued ms"] = cs.cuda_ms(lambda: torch.searchsorted(
        sk, torch.arange(nb + 1, device=dev)), 20)
    print("AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
