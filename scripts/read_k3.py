"""K3 (the Möbius transform) where its bytes bind, on one CUDA card.

Run from the repository root:  python3 scripts/read_k3.py [--src DIR]

(``--src``: measure the ``repro_torch`` package under DIR, another
checkout's ``src``, with this script and this checkout's ``chip_smoke``
helpers: a parent commit and its change on one card.)

Holds K3 bit for bit against its plain version and times it (device time
and CUDA events) beside its bound and ``matmul(T, X)`` at
``chip_smoke.K3_SCALING`` (``chip_smoke.k3_scaling_reading``) and at the
IMDb main path's largest call's shape, ``IMDB_SHAPE``, on counts from a
seeded generator.  Prints one JSON object of every reading as its last
line.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import k3_reading, k3_scaling_reading, log, nvidia_smi  # noqa: E402

# after chip_smoke, which puts this checkout's src first on the path
SRC = Path(sys.argv[sys.argv.index("--src") + 1]).resolve() \
    if "--src" in sys.argv else ROOT / "src"
sys.path.insert(0, str(SRC))

# [B, 2^k, D] of the IMDb main path's largest K3 call (chip_smoke phase 4)
IMDB_SHAPE = (3, 2, 27)


def main() -> None:
    if not torch.cuda.is_available():
        log("FAIL: this script needs a CUDA card")
        sys.exit(2)
    import repro_torch
    from repro_torch.kernels import build, ops
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
        f"package {Path(repro_torch.__file__).parent}")
    if Path(repro_torch.__file__).resolve().parent != SRC / "repro_torch":
        log(f"FAIL: repro_torch came from {repro_torch.__file__}, not {SRC}")
        sys.exit(1)
    build.load()
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randint(0, 1000, IMDB_SHAPE, generator=gen,
                      device="cuda").float()
    imdb = k3_reading(ops, x)
    log(f"K3 at the IMDb shape [{imdb['shape']}]: bit for bit; device "
        f"{imdb['device_ms']} ms (events {imdb['ms']:.4f}), matmul(T, X) "
        f"device {imdb['library_device_ms']} ms, bound "
        f"{imdb['bound_ms']:.7f} ms")
    scaling = k3_scaling_reading(ops)
    log(nvidia_smi())
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), smi=smi,
                          src=str(SRC), imdb=imdb, scaling=scaling)))


if __name__ == "__main__":
    main()
