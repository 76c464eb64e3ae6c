"""Three-term roofline on the H100; the JAX package's ``repro.roofline``.

    compute    = FLOPs            / (chips x 989 TF/s bf16)
    memory     = bytes            / (chips x 3.35 TB/s HBM3)
    collective = collective_bytes / (chips x 450 GB/s NVLink)

The reference reads FLOPs and bytes from XLA's ``cost_analysis`` and the
collective bytes from the compiled HLO text (``parse_collectives``).  The
port compiles no HLO, so it has no ``parse_collectives``: its collective
traffic is counted as it runs, in :data:`repro_torch.parallel.collectives
.STAGED` (bytes to and from the host, calls, seconds).  ``roofline_terms``
takes the same ``collectives`` mapping (``{kind: {"link_bytes": ...}}``),
so such counts, or any other, go in as the reference's do.

The constants are the NVIDIA H100 SXM data sheet's, the ones
``chip_smoke.py`` bounds every kernel by: dense bf16 tensor-core peak,
float32 outside the tensor cores, HBM3 bandwidth, and NVLink 4's 900 GB/s
bidirectional per card, 450 GB/s each way.
"""

from __future__ import annotations

from typing import Dict

#: H100 SXM, dense bf16 tensor-core operations per second
PEAK_FLOPS_BF16 = 989e12
#: H100 SXM, float32 operations per second outside the tensor cores
PEAK_FLOPS_F32 = 67e12
#: H100 SXM HBM3 bytes per second
HBM_BW = 3.35e12
#: H100 SXM NVLink 4, bytes per second each way (900 GB/s bidirectional)
LINK_BW = 450e9


def roofline_terms(cost: Dict[str, float], collectives: Dict[str, Dict],
                   chips: int, *, per_device_cost: bool = True,
                   peak_flops: float = PEAK_FLOPS_BF16,
                   hbm_bw: float = HBM_BW,
                   ici_bw: float = LINK_BW) -> Dict[str, float]:
    """The three terms and the one that binds, from ``cost`` (``"flops"``,
    ``"bytes accessed"``) and ``collectives`` (``{kind: {"link_bytes":
    ...}}``); ``ici_bw`` keeps the reference's name for the chip-to-chip
    link (NVLink here)."""
    flops = float(cost.get("flops", 0.0) or 0.0)
    nbytes = float(cost.get("bytes accessed", 0.0) or 0.0)
    if not per_device_cost:
        flops /= chips
        nbytes /= chips
    coll_bytes = sum(v["link_bytes"] for v in collectives.values())
    t_compute = flops / peak_flops
    t_memory = nbytes / hbm_bw
    t_coll = coll_bytes / ici_bw
    dom = max((t_compute, "compute"), (t_memory, "memory"),
              (t_coll, "collective"))
    return {
        "flops_per_chip": flops, "bytes_per_chip": nbytes,
        "collective_bytes_per_chip": coll_bytes,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "bottleneck": dom[1],
        "t_bound_s": dom[0],
    }


def model_flops(cfg, shape, chips: int) -> Dict[str, float]:
    """MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D; D = tokens processed.

    For decode shapes, one token per sequence is processed per step."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.tokens
        flops = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.tokens
        flops = 2.0 * n_active * tokens       # forward only
    else:
        tokens = shape.global_batch           # one new token per sequence
        flops = 2.0 * n_active * tokens
    return {"model_flops_total": flops, "model_flops_per_chip": flops / chips,
            "tokens": tokens}
