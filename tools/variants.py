"""The build step of the kernel-variant scripts: copies of a kernel source
of ``relationprediction_torch/ops/csrc`` with text edits, under
build/variants, one nvcc each, all started together."""
from __future__ import annotations

import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from relationprediction_torch.ops import nvcc

OUT = Path(__file__).resolve().parent.parent / "build" / "variants"


def build(source: str, name: str, edits, kernel: str = "") -> tuple:
    """Compile ``source`` with ``edits`` ((old, new) pairs; each old text
    must occur once) as the variant ``name``: (library path, ptxas' lines
    of the kernels whose names hold ``kernel``, joined by "; ", or None).
    Raises where an edit no longer matches the source or nvcc fails."""
    src = (nvcc.CSRC / source).read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise AssertionError(f"{name}: {source} holds {old!r} "
                                 f"{src.count(old)} times, not once")
        src = src.replace(old, new)
    stem = f"{Path(source).stem}_{name}"
    cu = OUT / f"{stem}.cu"
    cu.write_text(src)
    lib = OUT / f"{stem}.so"
    proc = subprocess.run([nvcc.nvcc_path(), *nvcc.NVCC_FLAGS, "-I",
                           str(nvcc.CSRC), "-o", str(lib), str(cu)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    ptxas = [line.split(": ", 1)[1]
             for line in nvcc.ptxas_summary(proc.stderr)
             if kernel and kernel in line]
    return lib, "; ".join(ptxas) if ptxas else None


def build_all(source: str, variants: dict, kernel: str = "") -> dict:
    """``build`` of every variant (name -> edits) at once: name ->
    (library path, ptxas' line)."""
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(variants)) as pool:
        return dict(zip(variants, pool.map(
            lambda name: build(source, name, variants[name], kernel),
            variants)))
