"""Time M6, the mixed beam + continuum scatter, against its first design,
at other warps a block and with other numbers of bands in flight.

    python3 -m femcy_tpu_torch.tools.m6_designs

M6 (``csrc/mixed_scatter.cu``) walks a node's pairs with their ids and
run starts read 32 at a time, each block's kind fixed at compile time and
a ring of C3D4 bands in flight in shared memory; it keeps the
translation rows in shared memory and writes the rotation rows in the
output.  This script builds, beside the shipped library:

- the first M6 (the source below): a node's six rows in shared memory,
  each pair's id, block, division and band loaded one after the other,
  2 warps a block;
- the current source at 2, 4 and 8 warps a block (``FEMCY_M6_WARPS``)
  with 2, 4 or 8 C3D4 bands in flight a warp (``FEMCY_M6_RING``), one
  library each (``BUILDS``), with ptxas's registers and spills.

All sum every slot in ascending pair order from +0 over the same plan, so
all are bit-equal; the script checks that, then times them in turns with
CUDA events (each twice, the order mirrored) at full width on the mixed
box of ``chip_smoke.py`` phase 22 (box_tets(56) under a grid of 6,384
B31 members on its z = 1 face; 1,111,158 dofs), in float32 and float64.
It prints each time with its share of the bound (bytes moved over 3.35
TB/s, reckoned as in ``chip_smoke.py``), each current build's registers,
spills and resident blocks an SM, and the card's name and power limit.
Needs one NVIDIA H100 and nvcc.  About half a minute of command.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys

import numpy as np
import torch

from femcy_tpu_torch.kernels import _build
from femcy_tpu_torch.kernels import mixed_scatter as km6
from femcy_tpu_torch.tools.force_designs import compare, verdict
from femcy_tpu_torch.tools.m1_band_loads import print_ptxas

HBM_BYTES_PER_S = 3.35e12
NX = 56
#: (warps a block, C3D4 bands in flight a warp)
BUILDS = ((2, 2), (2, 4), (2, 8), (4, 4), (4, 8), (8, 4))
#: the build that the shipped library is (the defaults of FEMCY_M6_WARPS
#: and FEMCY_M6_RING in the source)
SHIPPED = (2, 4)

# The first M6, as it was (csrc/mixed_scatter.cu), its entry points renamed
FIRST_M6_CU = r"""
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// warps (node row groups) per block
constexpr int kWarps = 2;
// the longest node row group (6 * W values, at 8 bytes a value) kept in
// shared memory (SHARED_ROW_BYTES in kernels/mixed_scatter.py)
constexpr int kRowBytes = 48 * 1024;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
mixed_row_kernel(const long long* __restrict__ blocks, int n_blocks,
                 const long long* __restrict__ node_ptr,
                 const int* __restrict__ pairs,
                 const short* __restrict__ positions, int stride, T* __restrict__ out, long long n_nodes, int width,
                 int row_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (n >= n_nodes) return;  // the whole warp
  const int len = 6 * width;
  T* dst = out + n * len;
  T* row = reinterpret_cast<T*>(smem) + warp * row_stride;
  for (int i = lane; i < len; i += 32) row[i] = T(0);
  __syncwarp();

  const long long lo = __ldg(node_ptr + n);
  const int np = static_cast<int>(__ldg(node_ptr + n + 1) - lo);
  for (int t = 0; t < np; ++t) {
    const int pid = __ldg(pairs + lo + t);
    const long long p = pid < 0 ? ~pid : pid;
    // the block of pair p: the last one whose first pair is <= p
    int b = 0;
    while (b + 1 < n_blocks && __ldg(blocks + (b + 1) * 4 + 1) <= p) ++b;
    const T* ke = reinterpret_cast<const T*>(__ldg(blocks + b * 4));
    const long long q = p - __ldg(blocks + b * 4 + 1);
    const int npe = static_cast<int>(__ldg(blocks + b * 4 + 2));
    const int dm = static_cast<int>(__ldg(blocks + b * 4 + 3));
    const int edof = npe * dm;
    const int band = dm * edof;
    const long long e = q / npe;
    const int a = static_cast<int>(q - e * npe);
    const T* src = ke + (e * edof + a * dm) * edof;
    const int pos = lane < stride
        ? static_cast<int>(__ldg(positions + (lo + t) * stride + lane)) : 0;
    for (int r = 0; r * 32 < band; ++r) {
      const int j = r * 32 + lane;
      const bool act = j < band;
      const int jj = act ? j : 0;
      const int di = jj / edof;
      const int col = jj - di * edof;
      const int bl = col / dm;
      const int dj = col - bl * dm;
      const int start = __shfl_sync(kFull, pos, di >= 3 ? 2 + bl : bl);
      const int slot = di * width + start + dj;
      const T v = act ? __ldg(src + j) : T(0);
      if (pid >= 0) {
        if (act) row[slot] += v;
      } else {
        // the element names a node twice: two b share a slot, so add the
        // b in ascending order
        for (int bb = 0; bb < npe; ++bb) {
          if (act && bl == bb) row[slot] += v;
          __syncwarp();
        }
      }
    }
    __syncwarp();
  }

  for (int i = lane; i < len; i += 32) dst[i] = row[i];
}

template <typename T>
int launch(const long long* blocks, int n_blocks, const long long* node_ptr,
           const int* pairs, const short* positions, int stride, T* out,
           long long n_nodes, int width, void* stream) {
  if (n_nodes <= 0) return 0;
  if (n_blocks < 1 || stride < 1 || stride > 32 || width < 1 ||
      6 * width * 8 > kRowBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  // row groups start on 16-byte boundaries
  const int row_stride = (6 * width * static_cast<int>(sizeof(T)) + 15) / 16
      * 16 / static_cast<int>(sizeof(T));
  const int smem = kWarps * row_stride * static_cast<int>(sizeof(T));
  auto kernel = mixed_row_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long grid = (n_nodes + kWarps - 1) / kWarps;
  kernel<<<static_cast<unsigned int>(grid), kWarps * 32, smem,
           static_cast<cudaStream_t>(stream)>>>(
      blocks, n_blocks, node_ptr, pairs, positions, stride, out, n_nodes,
      width, row_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int first_mixed_scatter_f32(const long long* blocks, int n_blocks,
                                       const long long* node_ptr,
                                       const int* pairs,
                                       const short* positions, int stride,
                                       float* out, long long n_nodes,
                                       int width, void* stream) {
  return launch<float>(blocks, n_blocks, node_ptr, pairs, positions, stride,
                       out, n_nodes, width, stream);
}

extern "C" int first_mixed_scatter_f64(const long long* blocks, int n_blocks,
                                       const long long* node_ptr,
                                       const int* pairs,
                                       const short* positions, int stride,
                                       double* out, long long n_nodes,
                                       int width, void* stream) {
  return launch<double>(blocks, n_blocks, node_ptr, pairs, positions, stride,
                        out, n_nodes, width, stream);
}
"""

_FIRST_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_void_p])


def build_designs() -> dict:
    """{name: CDLL}: the first M6 and the current source at each of
    ``BUILDS``, compiled for sm_90a into the build directory, one nvcc
    each, all started together."""
    if _build.find_nvcc() is None:
        raise RuntimeError("nvcc not found")
    src = (_build.CSRC / "mixed_scatter.cu").read_text()
    h = hashlib.sha256((FIRST_M6_CU + src + " ".join(_build.NVCC_FLAGS))
                       .encode()).hexdigest()[:16]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    first = _build.BUILD_DIR / f"first_m6-{h}.cu"
    first.write_text(FIRST_M6_CU)
    jobs = {"first M6": [str(first)]}
    for w, k in BUILDS:
        jobs[_name(w, k)] = [f"-DFEMCY_M6_WARPS={w}", f"-DFEMCY_M6_RING={k}",
                             str(_build.CSRC / "mixed_scatter.cu")]
    procs = {}
    for name, args in jobs.items():
        lib = _build.BUILD_DIR / f"m6-{len(procs)}-{h}.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-shared", "-o", str(lib), *args]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE,
                                             text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        print_ptxas(name, err)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _name(warps: int, ring: int) -> str:
    return f"{warps} warps, ring {ring}"


def _entry(lib, name: str, argtypes):
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _call(fn, *args) -> None:
    code = fn(*args, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {code}")


def mixed_box(n: int):
    """chip_smoke.py's mixed box (``mixed_model``) as a MixedSystem on the
    card: box_tets(n) in LinearIsotropic(1000, 0.3) under a grid of B31
    members (RECT 0.02, E 2e5, nu 0.3) on every x- and y-line of its z = 1
    face."""
    from femcy_tpu_torch import (BeamBlock, BeamSection, ElementBlock,
                                 LinearIsotropic, MixedSystem)
    from femcy_tpu_torch.meshgen import box_tets

    mesh = box_tets(n, n, n)
    top = np.nonzero(mesh.nodes[:, 2] > 1 - 1e-9)[0]
    grid = np.empty((n + 1, n + 1), dtype=np.int64)
    ij = np.rint(mesh.nodes[top, :2] * n).astype(np.int64)
    grid[ij[:, 0], ij[:, 1]] = top
    members = np.concatenate([
        np.stack([grid[:-1].ravel(), grid[1:].ravel()], 1),
        np.stack([grid[:, :-1].ravel(), grid[:, 1:].ravel()], 1)])
    return MixedSystem(
        mesh.nodes,
        [ElementBlock(mesh.elements, mesh.element,
                      LinearIsotropic(1000.0, 0.3), "solid")],
        [BeamBlock(members.astype(np.int32), BeamSection.rect(0.02, 0.02),
                   2.0e5, 0.3, "grid")], device="cuda")


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    if not torch.cuda.is_available():
        print("m6_designs: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    _build.load_library()
    libs = build_designs()
    system = mixed_box(NX)
    plan = system._plan
    if plan.wide or plan.stride != 4 or km6.KIND_GENERIC in plan.kinds:
        raise RuntimeError("the first M6 takes the box's plan only")
    kes64 = system._element_matrices()
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        suffix = "_f64" if dtype == torch.float64 else "_f32"
        kes = [k.to(dtype).contiguous() for k in kes64]
        first_table = torch.tensor(
            [[k.data_ptr(), off, npe, dm] for k, (_, npe, dm), off
             in zip(kes, plan.blocks, plan.pair_offsets)],
            dtype=torch.int64, device="cuda")
        table = torch.tensor(
            [[k.data_ptr(), off, npe, kind] for k, (_, npe, _), kind, off
             in zip(kes, plan.blocks, plan.kinds, plan.pair_offsets)],
            dtype=torch.int64, device="cuda")

        def first():
            out = torch.empty(plan.out_shape, dtype=dtype, device="cuda")
            _call(_entry(libs["first M6"], "first_mixed_scatter" + suffix,
                         _FIRST_ARGTYPES),
                  first_table.data_ptr(), len(kes), plan.node_ptr.data_ptr(),
                  plan.pairs.data_ptr(), plan.positions.data_ptr(),
                  plan.stride, out.data_ptr(), plan.n_nodes, plan.width)
            return out

        def current(lib):
            fn = _entry(lib, "femcy_mixed_scatter" + suffix, km6._ARGTYPES)

            def go():
                out = torch.empty(plan.out_shape, dtype=dtype, device="cuda")
                _call(fn, table.data_ptr(), len(kes), 0,
                      plan.node_ptr.data_ptr(), plan.pairs.data_ptr(),
                      plan.positions.data_ptr(), plan.stride, 0,
                      out.data_ptr(), plan.n_nodes, plan.width)
                return out
            return go

        variants = {"first M6": first}
        for w, k in BUILDS:
            lib = libs[_name(w, k)]
            attr = (ctypes.c_int * 5)()
            query = lib.femcy_mixed_scatter_attributes
            query.argtypes = km6._ATTRIBUTES_ARGTYPES
            query.restype = ctypes.c_int
            code = query(int(dtype == torch.float64), 0, 0, plan.width,
                         ctypes.addressof(attr))
            if code != 0:
                raise RuntimeError(f"attributes: CUDA error {code}")
            print(f"{_name(w, k)} {name}: {attr[0]} registers, {attr[1]} "
                  f"local bytes, {attr[3]} blocks ({attr[3] * w} warps) "
                  f"resident an SM, {attr[4]} shared bytes a block",
                  flush=True)
            variants[_name(w, k)] = current(lib)
        if not torch.equal(variants[_name(*SHIPPED)](),
                           km6.scatter(kes, plan)):
            raise RuntimeError("the shipped M6 differs from its build here")
        size = plan.n_dof * plan.width * kes[0].element_size()
        n_bytes = (sum(k.numel() * k.element_size() for k in kes) + size
                   + plan.node_ptr.numel() * 8 + plan.pairs.numel() * 4
                   + plan.positions.numel() * 2)
        label = f"M6 mixed box {name}"
        means = compare(label, card, variants,
                        n_bytes / HBM_BYTES_PER_S * 1e3)
        verdict(label, min(list(means)[1:], key=means.get), means)
        del kes, first_table, table
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
