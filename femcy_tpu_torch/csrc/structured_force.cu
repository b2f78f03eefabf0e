// Structured-box internal-force scatter for Hopper, in gather form (M5).
//
// Replaces femcy_tpu/structured.py structured_force_scatter (:476-495), the
// box's Newton-path internal force: element forces f_e (E, 4, 3) of a Kuhn
// box in cell-major order summed into nodal forces (n_nodes, 3) by 6
// orientations x 4 local nodes of corner-shifted dense adds, with no
// scatter (XLA runs them as 24 padded slice adds).
//
// Inputs: f_e[((cell * 6 + o) * 4 + a) * 3 + i], cell = (cx * ny + cy) * nz
// + cz, nc = nx * ny * nz; and the 24 corner shifts (dx, dy, dz) of local
// node a of orientation o (the box's corner_delta[kuhn[o][a]]), passed by
// value in the kernel's parameter space.
// Output: out[node * 3 + i] over the (nx + 1) (ny + 1) (nz + 1) grid nodes.
//
// What bounds it on the H100: reading f_e once (72 values a cell, 101 MB in
// f64 at NX=56) and writing the 3 n_nodes outputs.  One add per value read:
// memory bound.
//
// Design:
// - Gather form, one thread per grid node, 3 accumulators in registers.
//   The thread visits the 24 (o, a) shifts, orientation outer, local node
//   inner, and adds the 3 values of cell node - shift where that cell lies
//   in the box.  That is the order in which the plain version's 24 slice
//   adds reach each node, from +0, so the result is bit for bit the plain
//   version's, with no atomics, identical from run to run.
// - Neighbouring threads take neighbouring nodes along z, so their cells
//   are neighbours too; every value of f_e is read by exactly one thread.
// - 64-bit index arithmetic: f_e holds 75.9M values at NX=56, and larger
//   boxes pass 2^31.

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
extern "C" int femcy_structured_force_f32(const float* f_e, float* out,
                                          const int* shifts, int nx, int ny,
                                          int nz, void* stream) {
  return launch<float>(f_e, out, shifts, nx, ny, nz, stream);
}

extern "C" int femcy_structured_force_f64(const double* f_e, double* out,
                                          const int* shifts, int nx, int ny,
                                          int nz, void* stream) {
  return launch<double>(f_e, out, shifts, nx, ny, nz, stream);
}
