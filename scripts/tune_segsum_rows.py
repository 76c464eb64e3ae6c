"""Time K2's row scatter in each regime and launch shape on one CUDA card.

Run from the repository root:  python3 scripts/tune_segsum_rows.py

Takes K2's largest call of the IMDb main path (the root combine) and of
VisualGenome pre-counting (the largest overall and the largest in the
direct regime, the dense-message hop), all at full size, by the same spy
as ``chip_smoke.py``, and K5's largest ``bench_hist`` shape.  At each it
runs the plan :func:`repro_torch.kernels.segsum.rows_plan` chooses, the
direct regime, and privatised plans of other tiles and edge splits; each
is checked bit for bit against the plain version (K5's float values
within ``rtol=1e-5, atol=1e-3``) and timed on device time
(``chip_smoke.device_ms``), beside ``index_add_`` and the bound.  Prints
one line per plan and, last, one JSON object of every reading.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (IMDB_SCALE, VG_SCALE, Spy, bound_ms,  # noqa: E402
                        device_ms, log, nvidia_smi)

TILES = (16, 32, 64, 128, 256, 512, 1024)
SPLITS_PER_SM = (0.5, 1, 2, 4)


def plans(e: int, d: int, p: int, card):
    from repro_torch.kernels.segsum import (RowsPlan, direct_plan,
                                            privatisation_limit, rows_plan)
    out = {"chosen": rows_plan(e, d, p, card),
           "direct": direct_plan(e, d, card)}
    for tile in TILES:
        if p > privatisation_limit(card) or tile > 8 * -(-d // 4):
            continue
        tiles = -(-d // tile)
        for per_sm in SPLITS_PER_SM:
            splits = max(1, min(65535, round(per_sm * card.sms / tiles)))
            out[f"private T={tile} splits={splits}"] = RowsPlan(
                "private", tile, splits)
    return out


def sweep(label: str, seg, rows, p: int, exact: bool) -> list:
    from repro_torch.kernels.segsum import (card_of, segsum_rows_cuda,
                                            segsum_rows_plain)
    e, d = rows.shape
    card = card_of(rows.device)
    want = segsum_rows_plain(seg, rows, p)
    keep = (seg >= 0) & (seg < p)
    seg_l, kept = seg[keep].long(), rows[keep]
    b_ms, b_by = bound_ms(4.0 * e + 4.0 * e * d + 4.0 * p * d, e * d)
    lib = device_ms(lambda: torch.zeros((p, d), device=rows.device)
                    .index_add_(0, seg_l, kept))
    log(f"{label} [E={e} D={d} P={p}]: bound {b_ms:.4f} ms ({b_by}), "
        f"index_add_ {lib} ms (device)")
    readings = []
    for name, plan in plans(e, d, p, card).items():
        def run(plan=plan):
            return segsum_rows_cuda(seg, rows, p, torch.zeros(
                (p, d), device=rows.device), plan)
        got = run()
        err = float((got - want).abs().max())
        ok = err == 0.0 if exact else bool(
            torch.allclose(got, want, rtol=1e-5, atol=1e-3))
        ms = device_ms(run)
        log(f"  {name:32s} {list(plan)}: {ms} ms, max_abs_err {err}"
            f"{'' if ok else '  WRONG'}")
        readings.append(dict(shape=label, plan=name, regime=plan.regime,
                             tile=plan.tile, blocks=plan.blocks,
                             device_ms=ms, max_abs_err=err, ok=ok,
                             bound_ms=b_ms, library_device_ms=lib))
    return readings


def main() -> None:
    if not torch.cuda.is_available():
        log("FAIL: this script needs a CUDA card")
        sys.exit(2)
    from repro_torch.core import (build_lattice, discover_model,
                                  make_strategy, paper_benchmark_db)
    from repro_torch.kernels import ops
    from repro_torch.kernels.segsum import card_of, rows_plan
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
        f"{nvidia_smi()}; {card_of(torch.device('cuda'))}")
    readings = []
    spy = Spy(ops, ("segsum_rows",))
    discover_model(paper_benchmark_db("IMDb", seed=0, scale=IMDB_SCALE),
                   make_strategy("HYBRID", executor="sparse"),
                   max_chain_length=2, max_parents=3)
    spy.remove()
    readings += sweep("IMDb largest", *spy.big["segsum_rows"][1], exact=True)
    spy = Spy(ops, ("segsum_rows",), tags=lambda name, args, kwargs: (
        ("direct",) if rows_plan(args[1].shape[0], args[1].shape[1], args[2],
                                 card_of(args[1].device)).regime == "direct"
        else ()))
    vg = paper_benchmark_db("VisualGenome", seed=0, scale=VG_SCALE)
    make_strategy("HYBRID", executor="sparse").prepare(
        vg, build_lattice(vg.schema, 3))
    spy.remove()
    del vg
    readings += sweep("VisualGenome largest", *spy.big["segsum_rows"][1],
                      exact=True)
    readings += sweep("VisualGenome direct", *spy.big["direct"][1],
                      exact=True)
    del spy
    gen = torch.Generator(device="cuda").manual_seed(1)
    n, p, d = 262144, 1024, 64
    readings += sweep("K5 bench_hist largest",
                      torch.randint(0, p, (n,), generator=gen, device="cuda",
                                    dtype=torch.int32),
                      torch.rand((n, d), generator=gen, device="cuda"), p,
                      exact=False)
    log(nvidia_smi())
    print(json.dumps({"readings": readings}))
    if not all(r["ok"] for r in readings):
        log("FAIL: a plan differs from the plain version")
        sys.exit(1)


if __name__ == "__main__":
    main()
