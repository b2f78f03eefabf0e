"""Time M3, the block-ELL SpMV of the algebraic multigrid, against its
earlier designs on the AMG slice's hierarchy.

    python3 -m femcy_tpu_torch.tools.m3_designs

M3 (``csrc/bell_spmv.cu``) sums each output row in order, k then j, with
the loop over a row's blocks unrolled by 8.  This script builds, from that
source with the unroll pragma replaced, the first design (the loop not
unrolled) and an unroll by 4.  Every design sums each row in the same
order, so all are bit-equal; the script checks that on every operand of
the AMG slice's hierarchy (``unstructured_box_tets(56)``, z=0 clamped,
ux = 0.01 on z=1, ``preconditioner="amg"``, as ``chip_smoke.py`` phase
10b builds it), then times, in float64 and in mirrored turns (the first
design first and last): each operand, with its share of the bound (the
valid blocks' values and ids, the counts, x and y over 3.35 TB/s); one
V-cycle (device time); and one AMG-PCG (host clock), with the card's name
and power limit.  Needs one NVIDIA H100 and nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import subprocess
import sys
import time

import numpy as np
import torch

from femcy_tpu_torch.kernels import _build
from femcy_tpu_torch.kernels import bell_spmv as k_bell
from femcy_tpu_torch.tools.m1_band_loads import cuda_ms, print_ptxas

HBM_BYTES_PER_S = 3.35e12
NX = 56
#: the shipped kernel's k loop, and what each earlier design puts before it
LOOP = "#pragma unroll 8\n  for (int k = 0; k < count; ++k) {"
DESIGNS = {"first (not unrolled)": "", "unrolled by 4": "#pragma unroll 4\n"}
SHIPPED = "shipped (unrolled by 8)"


def build_designs() -> dict:
    """{name: spmv(op, x)} of the earlier designs, each compiled from the
    shipped source into its own library, and of the shipped kernel."""
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    src = (_build.CSRC / "bell_spmv.cu").read_text()
    if src.count(LOOP) != 1:
        raise RuntimeError("csrc/bell_spmv.cu no longer has the unrolled k loop")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    designs = {}
    for i, (name, pragma) in enumerate(DESIGNS.items()):
        text = src.replace(LOOP, pragma + LOOP.split("\n", 1)[1])
        h = hashlib.sha256((text + " ".join(_build.NVCC_FLAGS)).encode())
        cu = _build.BUILD_DIR / f"m3_design{i}-{h.hexdigest()[:16]}.cu"
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v",
                               "-shared", "-o", str(lib), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
        print_ptxas(name, proc.stderr)
        designs[name] = _launcher(ctypes.CDLL(str(lib)))
    designs[SHIPPED] = k_bell.spmv
    return designs


def _launcher(cdll):
    """spmv(op, x) through ``cdll``'s entry points, as the wrapper calls
    the shipped ones."""
    def spmv(op, x):
        fn = getattr(cdll, "femcy_bell_spmv_"
                     f"{k_bell._VALUE_NAMES[op.values_t.dtype]}_"
                     f"{k_bell._X_NAMES[x.dtype]}")
        fn.argtypes = k_bell._ARGTYPES
        fn.restype = ctypes.c_int
        y = torch.empty(op.values_t.shape[2], dtype=x.dtype, device=x.device)
        code = fn(op.values_t.data_ptr(), op.ncol_t.data_ptr(),
                  op.counts.data_ptr(), x.data_ptr(), y.data_ptr(),
                  op.n_blocks, op.br, op.bc,
                  torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"M3 design launch: CUDA error {code}")
        return y
    return spmv


@contextlib.contextmanager
def routed(spmv):
    """Every M3 call of the AMG (``kernels.bell_spmv.spmv``) through
    ``spmv`` inside the block."""
    shipped = k_bell.spmv
    k_bell.spmv = spmv
    try:
        yield
    finally:
        k_bell.spmv = shipped


def amg_slice():
    """The AMG slice's system, its eliminated operator and right-hand
    side, its hierarchy built."""
    from femcy_tpu_torch import FEMSystem, LinearIsotropic, SolverConfig
    from femcy_tpu_torch.bc import build_dirichlet_arrays
    from femcy_tpu_torch.io.inp import DirichletBC
    from femcy_tpu_torch.meshgen import unstructured_box_tets

    mesh = unstructured_box_tets(NX)
    z = mesh.nodes[:, 2]
    bottom, top = np.nonzero(z < 1e-9)[0], np.nonzero(z > z.max() - 1e-9)[0]
    bcs = [DirichletBC(bottom, d, 0.0) for d in range(3)]
    bcs.append(DirichletBC(top, 0, 0.01))
    fixed, sval = build_dirichlet_arrays(bcs, mesh, 1.0, 1.0, None)
    system = FEMSystem(mesh, LinearIsotropic(1000.0, 0.3), config=SolverConfig(
        preconditioner="amg", linear_solver="cg"), device="cuda")
    fixed = torch.as_tensor(fixed, device="cuda")
    sval = torch.as_tensor(sval, dtype=system.dtype, device="cuda")
    values, rhs, _ = system._linear_system(torch.zeros_like(system.dof),
                                           fixed, sval)
    system._ensure_amg(fixed, values=values)
    return system, values, rhs


def operands(system, values):
    """(label, operand) of the fine level and each level's A, P and R."""
    ops = [("fine", k_bell.from_ell(system._bell_fine, values))]
    for li, lv in enumerate(system._amg.levels):
        for what, op in (("A", lv.A), ("P", lv.P), ("R", lv.R)):
            if op is not None:
                ops.append((f"{what}{li}", op))
    return ops


def bound_ms(op, x) -> float:
    blocks = int(op.counts.sum())
    n_bytes = (blocks * (op.br * op.bc * op.values_t.element_size() + 4)
               + op.n_blocks * 4 + x.numel() * x.element_size()
               + op.values_t.shape[2] * x.element_size())
    return n_bytes / HBM_BYTES_PER_S * 1e3


def in_turns(designs: dict, fn, reps: int) -> dict:
    """{name: mean device ms of fn(design)}, each design timed twice, the
    order mirrored."""
    names = list(designs)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(cuda_ms(lambda: fn(designs[n]), reps))
    return {n: sum(t) / len(t) for n, t in times.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("m3_designs needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    designs = build_designs()
    system, values, rhs = amg_slice()
    amg = system._amg
    print(f"AMG slice: levels {[lv.n_dof for lv in amg.levels]}", flush=True)
    for what, op in operands(system, values):
        x = torch.as_tensor(np.random.default_rng(1).standard_normal(
            op.n_cols * op.bc), dtype=torch.float64, device="cuda")
        ref = designs[SHIPPED](op, x)
        for name, spmv in designs.items():
            if not torch.equal(spmv(op, x), ref):
                raise RuntimeError(f"{what}: {name} is not bit-equal")
        means = in_turns(designs, lambda spmv: spmv(op, x), 30)
        b = bound_ms(op, x)
        print(f"{what} ({op.n_blocks} block rows, K = {op.values_t.shape[0]}"
              f", {op.br} x {op.bc}, {str(op.values_t.dtype)[6:]} blocks, "
              f"bound {b:.4f} ms) on {card}, all bit-equal: " + "; ".join(
                  f"{n} {ms:.4f} ms ({b / ms:.1%})" for n, ms in means.items()),
              flush=True)
    fine = k_bell.from_ell(system._bell_fine, values)
    r = torch.as_tensor(np.random.default_rng(2).standard_normal(
        values.shape[0]), dtype=torch.float64, device="cuda")

    def cycle(spmv):
        with routed(spmv):
            return amg.precondition(r, lambda v: spmv(fine, v))

    ref = cycle(designs[SHIPPED])
    for name, spmv in designs.items():
        if not torch.equal(cycle(spmv), ref):
            raise RuntimeError(f"V-cycle: {name} is not bit-equal")
    means = in_turns(designs, cycle, 10)
    print(f"one V-cycle on {card}, device ms, all bit-equal: " + "; ".join(
        f"{n} {ms:.4f}" for n, ms in means.items()), flush=True)
    for name, spmv in designs.items():
        with routed(spmv):
            def pcg():
                return amg.pcg_solve(rhs, lambda v: spmv(fine, v),
                                     eps=system.config.cg_eps,
                                     max_iters=values.shape[0])
            _, iters, _ = pcg()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(5):
                pcg()
            torch.cuda.synchronize()
        print(f"AMG-PCG with {name} on {card}: {iters} iterations, "
              f"{(time.perf_counter() - t) / 5 * 1e3:.3f} ms of wall",
              flush=True)
    first = next(iter(means))
    print(f"verdict: {SHIPPED} {means[SHIPPED]:.4f} ms a V-cycle against "
          f"{first} {means[first]:.4f}: "
          f"{'lands' if means[SHIPPED] < means[first] else 'does not land'}"
          f" ({means[first] / means[SHIPPED]:.3f}x)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
