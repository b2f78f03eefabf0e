"""Time M4 and M5, the Newton path's internal-force kernels, against the
designs they replaced.

    python3 -m femcy_tpu_torch.tools.force_designs

M4 (``csrc/internal_force.cu``) sums node ``node_order[t]`` (nodes sorted
by their first pair) in a group of eight lanes, eight pairs loaded at a
time and added in order through shuffles; M5
(``csrc/structured_force.cu``) stages cell slabs of a (y, z) tile in
shared memory and marches along x.  This script builds, beside them, from
the sources below:

- the first M4: one thread per node in node-number order, one pair at a
  time;
- the first M5: one thread per grid node, 24 records read from global
  memory at a 576-byte stride (f64).

It also runs M4's kernel in node-number order, and M5 at other tiles than
the plan's.  All sum every value in the same order from +0, so all are
bit-equal; the script checks that, then times them in turns with CUDA
events (each design twice, the order mirrored: the first design first
and last) at full width, on ``unstructured_box_tets(56)`` (M4) and
``box_tets(56, 56, 56)`` (M5), in float32 and float64, and prints whether
each current kernel beats its first design ("lands").  Each time is
printed with its share of the bound (bytes moved over 3.35 TB/s, as in
``chip_smoke.py``), and the card's name and power limit.  It also prints
M4's reads at sector granularity (``internal_force.m4_read_sectors``).
Needs one NVIDIA H100 and nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys

import numpy as np
import torch

from femcy_tpu_torch.kernels import _build
from femcy_tpu_torch.kernels import ell_scatter as k_scat
from femcy_tpu_torch.kernels import internal_force as k_force
from femcy_tpu_torch.kernels import structured_force as k_sf
from femcy_tpu_torch.meshgen import box_tets, unstructured_box_tets
from femcy_tpu_torch.solvers.dia import build_structured_dia_pattern
from femcy_tpu_torch.structured import build_structured_plan
from femcy_tpu_torch.tools.m1_band_loads import cuda_ms, print_ptxas
from femcy_tpu_torch.topology import build_pattern

HBM_BYTES_PER_S = 3.35e12
NX = 56
#: M5 tiles (ty, tz, lx) timed beside the plan's, by dtype name
M5_TILES = {"float32": ((8, 8, 8), (8, 16, 15), (6, 8, 10)),
            "float64": ((6, 8, 8), (6, 8, 16), (6, 16, 19))}

# The first M4, as it was (csrc/internal_force.cu), its entry points renamed
FIRST_M4_CU = r"""
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int DM>
__global__ void internal_force_kernel(const T* __restrict__ f_e,
                                      const long long* __restrict__ node_ptr,
                                      const int* __restrict__ pairs,
                                      T* __restrict__ out, long long n_nodes) {
  const long long n =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= n_nodes) return;
  T acc[DM];
#pragma unroll
  for (int i = 0; i < DM; ++i) acc[i] = T(0);
  const long long t_end = __ldg(node_ptr + n + 1);
  for (long long t = __ldg(node_ptr + n); t < t_end; ++t) {
    int p = __ldg(pairs + t);
    if (p < 0) p = ~p;
    const T* src = f_e + static_cast<long long>(p) * DM;
#pragma unroll
    for (int i = 0; i < DM; ++i) acc[i] += __ldg(src + i);
  }
#pragma unroll
  for (int i = 0; i < DM; ++i) out[n * DM + i] = acc[i];
}

template <typename T>
int launch(const T* f_e, const long long* node_ptr, const int* pairs, T* out,
           long long n_nodes, int dm, void* stream) {
  if (n_nodes <= 0) return 0;
  const long long blocks = (n_nodes + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dm == 3) {
    internal_force_kernel<T, 3><<<static_cast<unsigned int>(blocks), kThreads,
                                  0, s>>>(f_e, node_ptr, pairs, out, n_nodes);
  } else if (dm == 2) {
    internal_force_kernel<T, 2><<<static_cast<unsigned int>(blocks), kThreads,
                                  0, s>>>(f_e, node_ptr, pairs, out, n_nodes);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int first_internal_force_f32(const float* f_e,
                                        const long long* node_ptr,
                                        const int* pairs, float* out,
                                        long long n_nodes, int dm,
                                        void* stream) {
  return launch<float>(f_e, node_ptr, pairs, out, n_nodes, dm, stream);
}

extern "C" int first_internal_force_f64(const double* f_e,
                                        const long long* node_ptr,
                                        const int* pairs, double* out,
                                        long long n_nodes, int dm,
                                        void* stream) {
  return launch<double>(f_e, node_ptr, pairs, out, n_nodes, dm, stream);
}
"""

# The first M5, as it was (csrc/structured_force.cu), its entry points renamed
FIRST_M5_CU = r"""
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kShifts = 24;  // 6 orientations x 4 local nodes

struct Shifts {
  int d[3 * kShifts];  // (dx, dy, dz) of shift o * 4 + a
};

template <typename T>
__global__ void structured_force_kernel(const T* __restrict__ f_e,
                                        T* __restrict__ out, const Shifts sh,
                                        int nx, int ny, int nz) {
  const long long n_nodes =
      static_cast<long long>(nx + 1) * (ny + 1) * (nz + 1);
  const long long node =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (node >= n_nodes) return;
  const long long plane_yz = static_cast<long long>(ny + 1) * (nz + 1);
  const int ix = static_cast<int>(node / plane_yz);
  const long long rem = node - ix * plane_yz;
  const int iy = static_cast<int>(rem / (nz + 1));
  const int iz = static_cast<int>(rem - static_cast<long long>(iy) * (nz + 1));

  T acc0 = T(0), acc1 = T(0), acc2 = T(0);
#pragma unroll
  for (int k = 0; k < kShifts; ++k) {  // k = o * 4 + a
    const int cx = ix - sh.d[3 * k];
    const int cy = iy - sh.d[3 * k + 1];
    const int cz = iz - sh.d[3 * k + 2];
    if (cx >= 0 && cx < nx && cy >= 0 && cy < ny && cz >= 0 && cz < nz) {
      const long long cell = (static_cast<long long>(cx) * ny + cy) * nz + cz;
      // (cell * 6 + o) * 4 + a == cell * 24 + k
      const T* src = f_e + (cell * kShifts + k) * 3;
      acc0 += __ldg(src);
      acc1 += __ldg(src + 1);
      acc2 += __ldg(src + 2);
    }
  }
  out[node * 3] = acc0;
  out[node * 3 + 1] = acc1;
  out[node * 3 + 2] = acc2;
}

template <typename T>
int launch(const T* f_e, T* out, const int* shifts, int nx, int ny, int nz,
           void* stream) {
  const long long n_nodes =
      static_cast<long long>(nx + 1) * (ny + 1) * (nz + 1);
  if (nx <= 0 || ny <= 0 || nz <= 0) return 0;
  Shifts sh;
  for (int i = 0; i < 3 * kShifts; ++i) sh.d[i] = shifts[i];
  const long long blocks = (n_nodes + kThreads - 1) / kThreads;
  structured_force_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      f_e, out, sh, nx, ny, nz);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ``shifts`` is a host array of 72 ints: (dx, dy, dz) for o * 4 + a.
extern "C" int first_structured_force_f32(const float* f_e, float* out,
                                          const int* shifts, int nx, int ny,
                                          int nz, void* stream) {
  return launch<float>(f_e, out, shifts, nx, ny, nz, stream);
}

extern "C" int first_structured_force_f64(const double* f_e, double* out,
                                          const int* shifts, int nx, int ny,
                                          int nz, void* stream) {
  return launch<double>(f_e, out, shifts, nx, ny, nz, stream);
}
"""

_SIGNATURES = {
    "first_internal_force": [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                                   ctypes.c_int],
    "first_structured_force": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3,
}


def _nvcc(args, what: str) -> None:
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                           "-v", *args], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {what}:\n{proc.stderr}")
    print_ptxas(what, proc.stderr)


def build_designs() -> ctypes.CDLL:
    """Compile the sources above for sm_90a into one library in the build
    directory, with ptxas's report for them and for M4 and M5."""
    if _build.find_nvcc() is None:
        raise RuntimeError("nvcc not found")
    sources = {"first_m4": FIRST_M4_CU, "first_m5": FIRST_M5_CU}
    h = hashlib.sha256("".join(sources.values()).encode()
                       + " ".join(_build.NVCC_FLAGS).encode()).hexdigest()[:16]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs = []
    for name, text in sources.items():
        src = _build.BUILD_DIR / f"{name}-{h}.cu"
        src.write_text(text)
        objs.append(str(src.with_suffix(".o")))
        _nvcc(["-c", "-o", objs[-1], str(src)], name)
    for name in ("internal_force", "structured_force"):
        _nvcc(["-c", "-o", str(_build.BUILD_DIR / f"{name}-{h}.o"),
               str(_build.CSRC / f"{name}.cu")], name)
    lib = _build.BUILD_DIR / f"force_designs-{h}.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                           "-o", str(lib), *objs], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to link:\n{proc.stderr}")
    cdll = ctypes.CDLL(str(lib))
    for stem, args in _SIGNATURES.items():
        for suffix in ("_f32", "_f64"):
            fn = getattr(cdll, stem + suffix)
            fn.argtypes = args + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return cdll


def _call(fn, *args) -> None:
    code = fn(*args, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {code}")


def _suffix(dtype) -> str:
    return "_f64" if dtype == torch.float64 else "_f32"


def compare(label: str, card: str, variants: dict, bound_ms: float) -> dict:
    """Check every variant bit for bit against the first one (the
    kernel's first design), time them in mirrored turns and print each
    with its share of the bound.  Returns {name: mean ms}."""
    ref = next(iter(variants.values()))()
    for name, fn in variants.items():
        if not torch.equal(fn(), ref):
            raise RuntimeError(f"{label}: {name} is not bit-equal to the "
                               "first design")
    order = list(variants) + list(variants)[::-1]
    times = {name: [] for name in variants}
    for name in order:
        times[name].append(cuda_ms(variants[name]))
    print(f"{label} on {card}: bound {bound_ms:.4f} ms (bytes); all "
          "bit-equal", flush=True)
    means = {}
    for name, ts in times.items():
        means[name] = sum(ts) / len(ts)
        print(f"  {name}: {ts[0]:.4f} / {ts[1]:.4f} ms, mean "
              f"{means[name]:.4f}, {bound_ms / means[name]:.1%} of the bound",
              flush=True)
    return means


def verdict(label: str, new: str, means: dict) -> None:
    old = next(iter(means))
    lands = means[new] < means[old]
    print(f"verdict {label}: {new} {means[new]:.4f} ms against {old} "
          f"{means[old]:.4f} ms: {'lands' if lands else 'does not land'} "
          f"({means[old] / means[new]:.3f}x)", flush=True)


def m4_designs(cdll, card: str) -> None:
    mesh = unstructured_box_tets(NX)
    plan = k_scat.build_scatter_plan(build_pattern(mesh), "cuda")
    n_nodes = plan.node_ptr.shape[0] - 1
    f_np = np.random.default_rng(8).standard_normal(
        (mesh.n_elements, mesh.element.n_nodes, mesh.dm))
    identity = torch.arange(n_nodes, dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.float64):
        f_e = torch.as_tensor(f_np, dtype=dtype, device="cuda")
        isz = f_e.element_size()

        def first():
            out = torch.empty(plan.n_dof, dtype=dtype, device="cuda")
            _call(getattr(cdll, "first_internal_force" + _suffix(dtype)),
                  f_e.data_ptr(), plan.node_ptr.data_ptr(),
                  plan.pairs.data_ptr(), out.data_ptr(), n_nodes, plan.dm)
            return out

        def shipped(order):
            def go():
                out = torch.empty(plan.n_dof, dtype=dtype, device="cuda")
                _build.launch(_build.entry(k_force._ENTRY[dtype],
                                           k_force._ARGTYPES),
                              f_e.device, "M4", f_e.data_ptr(),
                              plan.node_ptr.data_ptr(), plan.pairs.data_ptr(),
                              order.data_ptr(), out.data_ptr(), n_nodes,
                              plan.dm)
                return out
            return go

        variants = {
            "first design (a thread a node, node-number order)": first,
            "M4 (8 lanes a node, node_order)":
                lambda: k_force.scatter_force(f_e, plan),
            "M4's kernel in node-number order": shipped(identity),
        }
        n_bytes = ((f_e.numel() + plan.n_dof) * isz + plan.pairs.numel() * 4
                   + plan.node_ptr.numel() * 8)
        label = f"M4 unstructured_box_tets({NX}) {dtype}"
        means = compare(label, card, variants,
                        n_bytes / HBM_BYTES_PER_S * 1e3)
        verdict(label, list(variants)[1], means)
        sectors = k_force.m4_read_sectors(plan, isz)
        print(f"  {label} reads at 32-byte sectors: " + ", ".join(
            f"{k} {v / 1e6:.2f} MB ({v / HBM_BYTES_PER_S * 1e3:.4f} ms)"
            for k, v in sectors.items()), flush=True)
        del f_e
    torch.cuda.empty_cache()


def m5_designs(cdll, card: str) -> None:
    mesh = box_tets(NX, NX, NX)
    plan = build_structured_plan(mesh, build_structured_dia_pattern(mesh))
    shifts = plan.force_shifts
    f_np = np.random.default_rng(10).standard_normal((mesh.n_elements, 4, 3))
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        f_e = torch.as_tensor(f_np, dtype=dtype, device="cuda")

        def first():
            out = torch.empty(mesh.n_dof, dtype=dtype, device="cuda")
            _call(getattr(cdll, "first_structured_force" + _suffix(dtype)),
                  f_e.data_ptr(), out.data_ptr(), shifts.ctypes.data,
                  NX, NX, NX)
            return out

        def tiled(tile):
            return lambda: k_sf.launch_at(f_e, plan, tile)

        own = plan.force_tile[name]
        variants = {"first design (a thread a node, global loads)": first,
                    f"M5, plan tile {own}":
                        lambda: k_sf.force_scatter(f_e, plan, mesh)}
        for tile in M5_TILES[name]:
            variants[f"M5, tile {tile}"] = tiled(tile)
        n_bytes = (f_e.numel() + mesh.n_dof) * f_e.element_size()
        label = f"M5 box_tets({NX}) {dtype}"
        means = compare(label, card, variants,
                        n_bytes / HBM_BYTES_PER_S * 1e3)
        verdict(label, list(variants)[1], means)
        del f_e
    torch.cuda.empty_cache()


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    if not torch.cuda.is_available():
        print("force_designs: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    _build.load_library()
    cdll = build_designs()
    m5_designs(cdll, card)
    m4_designs(cdll, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
