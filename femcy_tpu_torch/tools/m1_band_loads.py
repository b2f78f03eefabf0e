"""Time M1's kernel against the bulk-copy design of the same row band.

    python3 -m femcy_tpu_torch.tools.m1_band_loads

M1 (``csrc/ell_scatter.cu``) keeps one band in flight in registers: each
lane loads its values of the next pair's Ke band while the current one is
added.  The other design moves each band into a shared ring of two
stages by bulk copies (the Tensor Memory Accelerator), completed on an
mbarrier, 4 warps a block.  Everything else (the plan, the walk, the
order of the adds, the output) is the same, so the two are bit-equal.
This script builds the bulk-copy design from the source below (short
rows only: int16 indices), checks it bit for bit against M1 and times
the two in turns (M1, bulk, bulk, M1) with CUDA events: on the ELL
slice's mesh (unstructured_box_tets(56))
and the general-DIA route (box_hexes(48, 48, 48)), in float32 and
float64.  Each time is printed with its share of the bound (bytes moved
over 3.35 TB/s, reckoned as in chip_smoke.py) and the card's name and
power limit.  Needs one NVIDIA H100 and nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys

import numpy as np
import torch

from femcy_tpu_torch import assembly
from femcy_tpu_torch.kernels import _build
from femcy_tpu_torch.kernels import ell_scatter as k_scat
from femcy_tpu_torch.materials import LinearIsotropic
from femcy_tpu_torch.meshgen import box_hexes, unstructured_box_tets
from femcy_tpu_torch.solvers.dia import build_dia_pattern
from femcy_tpu_torch.topology import build_pattern

HBM_BYTES_PER_S = 3.35e12

BULK_RING_CU = r"""
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;
constexpr int kStages = 2;
constexpr int kBarBytes = (8 * kStages + 15) / 16 * 16;

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Each warp's shared memory: kBarBytes of mbarriers, kStages stages of
// stage_len values, the ELL row (dm * W values); warp_bytes in all.
template <typename T, int MAXR>
__global__ void __launch_bounds__(kWarps * 32)
bulk_ring(const T* __restrict__ ke, const long long* __restrict__ node_ptr,
          const int* __restrict__ pairs, const short* __restrict__ positions,
          const short* __restrict__ dia_columns, T* __restrict__ out,
          long long n_nodes, int width, int n_cols, int npe, int dm,
          int stage_len, int warp_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (n >= n_nodes) return;
  const bool dia = dia_columns != nullptr;
  const int ell_len = dm * width;
  const int out_len = dia ? dm * n_cols : ell_len;
  T* dst = out + n * out_len;
  unsigned char* mine = smem + static_cast<long long>(warp) * warp_bytes;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(mine);
  T* ring = reinterpret_cast<T*>(mine + kBarBytes);
  T* row = ring + kStages * stage_len;
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   ::"r"(shared_addr(bars + s)), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = lane; i < ell_len; i += 32) row[i] = T(0);

  const int edof = npe * dm;
  const int band = dm * edof;
  int base[MAXR], bsel[MAXR];
  bool act[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    const int j = r * 32 + lane;
    act[r] = j < band;
    const int jj = act[r] ? j : 0;
    const int di = jj / edof, col = jj - di * edof;
    const int b = col / dm;
    base[r] = di * width + (col - b * dm);
    bsel[r] = b;
  }
  const long long lo = __ldg(node_ptr + n);
  const int np = static_cast<int>(__ldg(node_ptr + n + 1) - lo);
  int chunk = 0;
  int ids = lane < np ? __ldg(pairs + lo + lane) : 0;
  int pid[kStages], off[kStages], pos[kStages];
  unsigned phase = 0;
  __syncwarp();

  // start moving pair t's band (the 16-byte-aligned run around it) into
  // stage s with one bulk copy
  auto fetch = [&](int t, int s) {
    if (t >= np) return;
    if (t >= chunk + 32) {
      chunk += 32;
      ids = chunk + lane < np ? __ldg(pairs + lo + chunk + lane) : 0;
    }
    const int id = __shfl_sync(kFull, ids, t - chunk);
    pid[s] = id;
    const T* src = ke + static_cast<long long>(id < 0 ? ~id : id) * band;
    const unsigned long long from =
        reinterpret_cast<unsigned long long>(src) & ~15ull;
    const unsigned long long to =
        (reinterpret_cast<unsigned long long>(src + band) + 15ull) & ~15ull;
    off[s] = static_cast<int>(src - reinterpret_cast<const T*>(from));
    if (lane == 0) {
      const unsigned bar = shared_addr(bars + s);
      const unsigned bytes = static_cast<unsigned>(to - from);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(bar), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n"
          ::"r"(shared_addr(ring + s * stage_len)), "l"(from), "r"(bytes),
          "r"(bar) : "memory");
    }
    pos[s] = lane < npe
        ? static_cast<int>(__ldg(positions + (lo + t) * npe + lane)) : 0;
  };
  // wait for stage s, then add its band into the row
  auto apply = [&](int s) {
    asm volatile(
        "{\n\t.reg .pred P1;\n\tLAB_WAIT:\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
        "@P1 bra DONE;\n\tbra LAB_WAIT;\n\tDONE:\n\t}\n"
        ::"r"(shared_addr(bars + s)), "r"((phase >> s) & 1u) : "memory");
    phase ^= 1u << s;
    const T* vals = ring + s * stage_len + off[s] + lane;
    int slot[MAXR];
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      slot[r] = base[r] + __shfl_sync(kFull, pos[s], bsel[r]) * dm;
    if (pid[s] >= 0) {
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        if (act[r]) row[slot[r]] += vals[r * 32];
    } else {
      for (int b = 0; b < npe; ++b) {
#pragma unroll
        for (int r = 0; r < MAXR; ++r)
          if (act[r] && bsel[r] == b) row[slot[r]] += vals[r * 32];
        __syncwarp();
      }
    }
    __syncwarp();
  };

#pragma unroll
  for (int s = 0; s < kStages; ++s) fetch(s, s);
  for (int t0 = 0; t0 < np; t0 += kStages) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      if (t0 + s < np) {
        apply(s);
        fetch(t0 + s + kStages, s);
      }
    }
  }

  if (!dia) {
    for (int i = lane; i < ell_len; i += 32) dst[i] = row[i];
    return;
  }
  for (int i = lane; i < out_len; i += 32) dst[i] = T(0);
  __syncwarp();
  const short* cols = dia_columns + n * ell_len;
  for (int i = lane; i < ell_len; i += 32) {
    const int k = __ldg(cols + i);
    if (k >= 0) dst[(i / width) * n_cols + k] = row[i];
  }
}

template <typename T, int MAXR>
int launch_t(const T* ke, const long long* node_ptr, const int* pairs,
             const short* positions, const short* dia_columns, T* out,
             long long n_nodes, int width, int n_cols, int npe, int dm,
             cudaStream_t s) {
  const int band_bytes = dm * dm * npe * static_cast<int>(sizeof(T));
  const int stage_len = (band_bytes + 32 + 15) / 16 * 16 / sizeof(T);
  const int warp_bytes = kBarBytes + kStages * stage_len * sizeof(T) +
      (dm * width * static_cast<int>(sizeof(T)) + 15) / 16 * 16;
  const int smem = kWarps * warp_bytes;
  auto kernel = bulk_ring<T, MAXR>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (n_nodes + kWarps - 1) / kWarps;
  kernel<<<static_cast<unsigned int>(blocks), kWarps * 32, smem, s>>>(
      ke, node_ptr, pairs, positions, dia_columns, out, n_nodes, width,
      n_cols, npe, dm, stage_len, warp_bytes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* ke, const long long* node_ptr, const int* pairs,
           const short* positions, const short* dia_columns, T* out,
           long long n_nodes, int width, int n_cols, int npe, int dm,
           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rounds = (dm * dm * npe + 31) / 32;
  if (reinterpret_cast<unsigned long long>(ke) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rounds <= 2)
    return launch_t<T, 2>(ke, node_ptr, pairs, positions, dia_columns, out,
                          n_nodes, width, n_cols, npe, dm, s);
  if (rounds == 3)
    return launch_t<T, 3>(ke, node_ptr, pairs, positions, dia_columns, out,
                          n_nodes, width, n_cols, npe, dm, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int bulk_ring_f32(const float* ke, const long long* node_ptr,
                             const int* pairs, const short* positions,
                             const short* dia_columns, float* out,
                             long long n_nodes, int width, int n_cols,
                             int npe, int dm, void* stream) {
  return launch<float>(ke, node_ptr, pairs, positions, dia_columns, out,
                       n_nodes, width, n_cols, npe, dm, stream);
}

extern "C" int bulk_ring_f64(const double* ke, const long long* node_ptr,
                             const int* pairs, const short* positions,
                             const short* dia_columns, double* out,
                             long long n_nodes, int width, int n_cols,
                             int npe, int dm, void* stream) {
  return launch<double>(ke, node_ptr, pairs, positions, dia_columns, out,
                        n_nodes, width, n_cols, npe, dm, stream);
}
"""

def print_ptxas(what: str, stderr: str) -> None:
    """ptxas's registers and spills per instantiation (its -v report)."""
    name = ""
    for line in stderr.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif "registers" in line or "spill" in line:
            print(f"ptxas {what} {name}: {line.split(':', 1)[-1].strip()}")


def build_bulk_ring() -> ctypes.CDLL:
    """Compile BULK_RING_CU for sm_90a into the build directory; print
    ptxas's register and spill lines for it and for M1."""
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    h = hashlib.sha256((BULK_RING_CU + " ".join(_build.NVCC_FLAGS))
                       .encode()).hexdigest()[:16]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / f"bulk_ring-{h}.cu"
    lib = _build.BUILD_DIR / f"bulk_ring-{h}.so"
    src.write_text(BULK_RING_CU)
    proc = subprocess.run(
        [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
         str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    print_ptxas("bulk-copy design", proc.stderr)
    # M1's own instantiations, compiled alone for ptxas's report
    proc = subprocess.run(
        [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
         str(_build.BUILD_DIR / f"ell_scatter-{h}.o"),
         str(_build.CSRC / "ell_scatter.cu")], capture_output=True, text=True)
    print_ptxas("M1", proc.stderr)
    cdll = ctypes.CDLL(str(lib))
    for name in ("bulk_ring_f32", "bulk_ring_f64"):
        fn = getattr(cdll, name)
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return cdll


def bulk_ring(cdll, Ke, plan):
    out = torch.empty(plan.out_shape, dtype=Ke.dtype, device=Ke.device)
    fn = cdll.bulk_ring_f64 if Ke.dtype == torch.float64 else cdll.bulk_ring_f32
    cols = plan.dia_columns
    code = fn(Ke.data_ptr(), plan.node_ptr.data_ptr(), plan.pairs.data_ptr(),
              plan.positions.data_ptr(),
              None if cols is None else cols.data_ptr(), out.data_ptr(),
              plan.node_ptr.shape[0] - 1, plan.width, plan.out_shape[1],
              plan.npe, plan.dm, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"bulk_ring launch: CUDA error {code}")
    return out


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    if not torch.cuda.is_available():
        print("m1_band_loads: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    _build.load_library()
    cdll = build_bulk_ring()
    mat = LinearIsotropic(1000.0, 0.3)
    cases = (("unstructured_box_tets(56), ELL", unstructured_box_tets(56),
              False),
             ("box_hexes(48, 48, 48), general DIA", box_hexes(48, 48, 48),
              True))
    for label, mesh, on_dia in cases:
        pattern = build_pattern(mesh)
        dia = build_dia_pattern(mesh, ell=pattern) if on_dia else None
        plan = k_scat.build_scatter_plan(pattern, "cuda", dia=dia)
        assert not plan.wide
        plan_bytes = sum(t.numel() * t.element_size()
                         for t in (plan.node_ptr, plan.pairs, plan.positions,
                                   plan.dia_columns) if t is not None)
        for dtype in (torch.float32, torch.float64):
            def dev(a):
                return torch.as_tensor(np.asarray(a), dtype=dtype,
                                       device="cuda")

            dsdx, vol = assembly.gradients_and_volume(
                dev(mesh.nodes), torch.as_tensor(
                    mesh.elements.astype(np.int64), device="cuda"),
                dev(mesh.element.dshape_at_gp),
                dev(mesh.element.gauss_weights))
            Ke = assembly.element_stiffness(dsdx, vol, dev(mat.C))
            del dsdx, vol
            ref = k_scat.scatter(Ke, plan)
            variants = {
                "M1 (one band in registers, 2 warps)":
                    lambda: k_scat.scatter(Ke, plan),
                "bulk copies, 2 stages, 4 warps":
                    lambda: bulk_ring(cdll, Ke, plan),
            }
            for name, fn in variants.items():
                if not torch.equal(fn(), ref):
                    raise RuntimeError(f"{label} {dtype}: {name} is not "
                                       "bit-equal to M1")
            order = list(variants) + list(variants)[::-1]
            times = {name: [] for name in variants}
            for name in order:
                times[name].append(cuda_ms(variants[name]))
            bound = ((Ke.numel() + ref.numel()) * Ke.element_size()
                     + plan_bytes) / HBM_BYTES_PER_S * 1e3
            print(f"{label}, {dtype} on {card}: bound {bound:.4f} ms "
                  f"(bytes); all bit-equal", flush=True)
            for name, ts in times.items():
                mean = sum(ts) / len(ts)
                print(f"  {name}: {ts[0]:.4f} / {ts[1]:.4f} ms, mean "
                      f"{mean:.4f}, {bound / mean:.1%} of the bound",
                      flush=True)
            del Ke, ref
        del plan
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
