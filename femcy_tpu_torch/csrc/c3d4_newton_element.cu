// The box's C3D4 Newton element evaluation for Hopper, one thread per
// element (M9).
//
// Replaces no Pallas kernel: it takes the place of femcy_tpu's XLA einsums
// of the Newton evaluation on the structured box (system.py
// _internal_force_parts and _newton_eval: the kinematics, gp_stress(large),
// element_internal_force, element_stiffness + geometric_stiffness) and of
// the Ke -> planes transpose of structured_dia_scatter.  For each element,
// in registers:
//   F = I + sum_a u_a (x) grad0 N_a (grad0 N = dsdX0, the initial gradients);
//   the current gradients grad N = dN inv(J) and vol = det(J) w, where
//   J = sum_a x_a (x) dN_a is the edge matrix of x = X + u;
//   the Green strain E = (F^T F - I) / 2, S = C : E (C the 6x6 Voigt
//   tangent) and sigma = F S F^T / det F;
//   f[a, i] = vol sum_j grad N_a[j] sigma[j, i];
//   each 3x3 node block of Ke + Kg: vol (B_a^T C B_b) + delta_ij vol
//   (grad N_a . sigma grad N_b).
//
// Inputs: nodes (N, 3) and u (3 N) of the (nx + 1) (ny + 1) (nz + 1) grid
// nodes (u the pinned displacement); dsdX0 (E, 1, 4, 3), at any strides, in
// box_tets cell-major order, element e = cell * 6 + o, cell = (cx * ny + cy) * nz +
// cz, nc = nx ny nz cells; by value: C (6, 6), dN (4, 3) and w of the one
// Gauss point, and the 24 corner shifts (dx, dy, dz) of local node a of
// orientation o (the box's corner_delta[kuhn[o][a]]).
// Outputs: planes (6, 144, nc), entry [o, 12 p + q, cell] = (Ke + Kg)[p, q]
// of element cell * 6 + o, as the structured accumulate (P2) reads them;
// f_e (E, 4, 3), in the order the box force kernel (M5) reads; vol (E, 1).
//
// What bounds it on the H100: memory.  At NX=56 in f64 it writes the planes
// (1,214 MB), f_e (101 MB) and vol (8 MB) and reads dsdX0 (101 MB) and the
// nodes and u (9 MB, which L2 holds): ~1,433 MB, 0.428 ms at 3.35 TB/s.
// Its ~3,500 operations an element take 0.11 ms at the 34 TFLOP/s that f64
// has outside the tensor cores.
//
// Design:
// - One thread per element, no tensor cores and no shared memory: the
//   products are 3x3 and 6x3, and a tensor-core tile would waste nearly all
//   of its work on them (the einsum route's f64 GEMM tiles ran at ~0.1% of
//   the card's bound).
// - A block holds 128 cells of one orientation, and the orientation is
//   blockIdx.x % 6, so the six orientations of a run of cells are in
//   flight together: their dsdX0 and f_e records share lines in L2.
// - Lane c of orientation o writes plane entry [o, pq, c]: every store of
//   a warp is 32 consecutive values, and the planes need no transpose.
//   They are stored with the evict-first hint (P2 reads them only after
//   the kernel has ended, long after L2 has turned over).
// - The element's nodes are found by grid index (cell + corner shift), with
//   no connectivity read and no gather table.
// - Registers: the 12 current gradients, sigma, vol and one node's C B_b
//   (6 x 3) are live while the 16 node blocks are made one at a time, node
//   b outer and node a inner; C, dN, w and the shifts sit in the kernel's
//   parameter space (a uniform read a warp).
// - Summation orders follow the plain version's einsums where it costs
//   nothing (sums over the nodes from a = 0, then + I; the adjugate
//   inverse divided by the determinant, as linalg.inv_small), so the f64
//   results agree with it to a few ulps (the compiler contracts to FMAs).
// - 64-bit index arithmetic: the planes hold 152M values at NX=56, and
//   boxes past about 110^3 cells pass 2^31.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
struct Consts {
  T C[36];     // the 6x6 Voigt tangent, row-major
  T dN[12];    // d(shape)/d(natural) of the Gauss point, [a][d]
  T w;         // its weight
  int d[72];   // (dx, dy, dz) of local node a of orientation o, at o * 4 + a
};

// Column j of a node's Voigt B (6 x 3) has three entries: row b_row(j, t)
// holds gradient component b_grad(j, t), t = 0, 1, 2 (j = 0: rows 0, 3, 4
// hold Nx, Ny, Nz; j = 1: rows 1, 3, 5 hold Ny, Nx, Nz; j = 2: rows 2, 4, 5
// hold Nz, Nx, Ny).  Called with constants, so they fold away.
__device__ __forceinline__ constexpr int b_row(int j, int t) {
  return t == 0 ? j : t == 1 ? (j == 2 ? 4 : 3) : (j == 0 ? 4 : 5);
}

__device__ __forceinline__ constexpr int b_grad(int j, int t) {
  return t == 0 ? j : t == 1 ? (j == 0 ? 1 : 0) : (j == 2 ? 1 : 2);
}

__device__ __forceinline__ void store_stream(double* p, double v) {
  __stcs(p, v);
}

__device__ __forceinline__ void store_stream(float* p, float v) {
  __stcs(p, v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    newton_element_kernel(const T* __restrict__ nodes, const T* __restrict__ u,
                          const T* __restrict__ dsdX0, T* __restrict__ planes,
                          T* __restrict__ f_e, T* __restrict__ vol_out,
                          const Consts<T> k, int nx, int ny, int nz,
                          long long se, long long sa, long long sj) {
  const long long nc = static_cast<long long>(nx) * ny * nz;
  const int o = blockIdx.x % 6;
  const long long c =
      static_cast<long long>(blockIdx.x / 6) * kThreads + threadIdx.x;
  if (c >= nc) return;
  const long long e = c * 6 + o;
  const int cz = static_cast<int>(c % nz);
  const long long cxy = c / nz;
  const int cy = static_cast<int>(cxy % ny);
  const int cx = static_cast<int>(cxy / ny);

  // the corner shifts of this orientation, picked with constant indices
  // (a parameter read at a computed index would copy the table to local
  // memory)
  int sh[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) sh[q] = k.d[q];
#pragma unroll
  for (int oo = 1; oo < 6; ++oo)
    if (o == oo)
#pragma unroll
      for (int q = 0; q < 12; ++q) sh[q] = k.d[oo * 12 + q];

  // the element's nodal displacements and current coordinates
  T ue[4][3], xe[4][3];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long long node =
        (static_cast<long long>(cx + sh[3 * a]) * (ny + 1) +
         (cy + sh[3 * a + 1])) * (nz + 1) +
        (cz + sh[3 * a + 2]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ue[a][i] = u[node * 3 + i];
      xe[a][i] = nodes[node * 3 + i] + ue[a][i];
    }
  }

  // F = I + sum_a u_a (x) grad0 N_a
  T F[3][3];
  {
    T g0[4][3];
    const T* g = dsdX0 + e * se;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 3; ++j) g0[a][j] = g[a * sa + j * sj];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        T h = ue[0][i] * g0[0][j];
#pragma unroll
        for (int a = 1; a < 4; ++a) h += ue[a][i] * g0[a][j];
        F[i][j] = h + (i == j ? T(1) : T(0));
      }
  }

  // current gradients and volume: J[D][d] = sum_a x_a[D] dN_a[d]
  T ds[4][3], vol;
  {
    T J[3][3];
#pragma unroll
    for (int D = 0; D < 3; ++D)
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        T s = xe[0][D] * k.dN[d];
#pragma unroll
        for (int a = 1; a < 4; ++a) s += xe[a][D] * k.dN[a * 3 + d];
        J[D][d] = s;
      }
    const T det =
        J[0][0] * (J[1][1] * J[2][2] - J[1][2] * J[2][1]) -
        J[0][1] * (J[1][0] * J[2][2] - J[1][2] * J[2][0]) +
        J[0][2] * (J[1][0] * J[2][1] - J[1][1] * J[2][0]);
    // inv[d][D]: the adjugate (transposed cofactors) over det
    T inv[3][3];
    inv[0][0] = (J[1][1] * J[2][2] - J[1][2] * J[2][1]) / det;
    inv[0][1] = -(J[0][1] * J[2][2] - J[0][2] * J[2][1]) / det;
    inv[0][2] = (J[0][1] * J[1][2] - J[0][2] * J[1][1]) / det;
    inv[1][0] = -(J[1][0] * J[2][2] - J[1][2] * J[2][0]) / det;
    inv[1][1] = (J[0][0] * J[2][2] - J[0][2] * J[2][0]) / det;
    inv[1][2] = -(J[0][0] * J[1][2] - J[0][2] * J[1][0]) / det;
    inv[2][0] = (J[1][0] * J[2][1] - J[1][1] * J[2][0]) / det;
    inv[2][1] = -(J[0][0] * J[2][1] - J[0][1] * J[2][0]) / det;
    inv[2][2] = (J[0][0] * J[1][1] - J[0][1] * J[1][0]) / det;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int D = 0; D < 3; ++D) {
        T s = k.dN[a * 3] * inv[0][D];
        s += k.dN[a * 3 + 1] * inv[1][D];
        s += k.dN[a * 3 + 2] * inv[2][D];
        ds[a][D] = s;
      }
    vol = det * k.w;
  }

  // sigma = F S F^T / det F, S = C : E, E = (F^T F - I) / 2
  T sig[3][3];
  {
    T Ev[6];
    {
      T E[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const T ftf = F[0][i] * F[0][j] + F[1][i] * F[1][j] +
                        F[2][i] * F[2][j];
          E[i][j] = (ftf - (i == j ? T(1) : T(0))) / T(2);
        }
      Ev[0] = E[0][0];
      Ev[1] = E[1][1];
      Ev[2] = E[2][2];
      Ev[3] = T(2) * E[0][1];
      Ev[4] = T(2) * E[2][0];
      Ev[5] = T(2) * E[1][2];
    }
    T Sv[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      T s = k.C[r * 6] * Ev[0];
#pragma unroll
      for (int q = 1; q < 6; ++q) s += k.C[r * 6 + q] * Ev[q];
      Sv[r] = s;
    }
    const T S[3][3] = {{Sv[0], Sv[3], Sv[4]},
                       {Sv[3], Sv[1], Sv[5]},
                       {Sv[4], Sv[5], Sv[2]}};
    const T detF =
        F[0][0] * (F[1][1] * F[2][2] - F[1][2] * F[2][1]) -
        F[0][1] * (F[1][0] * F[2][2] - F[1][2] * F[2][0]) +
        F[0][2] * (F[1][0] * F[2][1] - F[1][1] * F[2][0]);
    T FS[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        FS[i][j] = F[i][0] * S[0][j] + F[i][1] * S[1][j] + F[i][2] * S[2][j];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        sig[i][j] = (FS[i][0] * F[j][0] + FS[i][1] * F[j][1] +
                     FS[i][2] * F[j][2]) / detF;
  }

  // the element force f[a, i] = vol sum_j grad N_a[j] sigma[j, i]
  vol_out[e] = vol;
  T* fo = f_e + e * 12;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      fo[a * 3 + i] = (ds[a][0] * sig[0][i] + ds[a][1] * sig[1][i] +
                       ds[a][2] * sig[2][i]) * vol;

  // Ke + Kg, one node block (a, b) at a time
  T* pl = planes + static_cast<long long>(o) * 144 * nc + c;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    // (C B_b)[r][j] and sigma grad N_b
    T CB[6][3];
#pragma unroll
    for (int r = 0; r < 6; ++r)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        CB[r][j] = k.C[r * 6 + b_row(j, 0)] * ds[b][b_grad(j, 0)] +
                   k.C[r * 6 + b_row(j, 1)] * ds[b][b_grad(j, 1)] +
                   k.C[r * 6 + b_row(j, 2)] * ds[b][b_grad(j, 2)];
    T sb[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      sb[i] = sig[i][0] * ds[b][0] + sig[i][1] * ds[b][1] +
              sig[i][2] * ds[b][2];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const T g = (ds[a][0] * sb[0] + ds[a][1] * sb[1] + ds[a][2] * sb[2]) *
                  vol;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          // (B_a^T C B_b)[i][j] = sum over the three rows of B_a's column i
          const T kij = (ds[a][b_grad(i, 0)] * CB[b_row(i, 0)][j] +
                         ds[a][b_grad(i, 1)] * CB[b_row(i, 1)][j] +
                         ds[a][b_grad(i, 2)] * CB[b_row(i, 2)][j]) * vol;
          const int pq = (3 * a + i) * 12 + 3 * b + j;
          store_stream(pl + static_cast<long long>(pq) * nc,
                       i == j ? kij + g : kij);
        }
    }
  }
}

template <typename T>
int launch(const T* nodes, const T* u, const T* dsdX0, T* planes, T* f_e,
           T* vol, const T* C, const T* dN, T w, const int* shifts, int nx,
           int ny, int nz, long long se, long long sa, long long sj,
           void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0) return 0;
  Consts<T> k;
  for (int i = 0; i < 36; ++i) k.C[i] = C[i];
  for (int i = 0; i < 12; ++i) k.dN[i] = dN[i];
  k.w = w;
  for (int i = 0; i < 72; ++i) {
    if (shifts[i] != 0 && shifts[i] != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    k.d[i] = shifts[i];
  }
  const long long nc = static_cast<long long>(nx) * ny * nz;
  const long long blocks = 6 * ((nc + kThreads - 1) / kThreads);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  newton_element_kernel<T>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(nodes, u, dsdX0, planes, f_e,
                                              vol, k, nx, ny, nz, se, sa,
                                              sj);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C, dN are host arrays of 36 and 12 values and shifts one of 72 ints, all
// passed to the kernel by value; dsdX0's value (e, a, j) sits at e * se +
// a * sa + j * sj (the setup's einsum leaves it strided).
extern "C" int femcy_newton_element_f32(const float* nodes, const float* u,
                                        const float* dsdX0, float* planes,
                                        float* f_e, float* vol, const float* C,
                                        const float* dN, float w,
                                        const int* shifts, int nx, int ny,
                                        int nz, long long se, long long sa,
                                        long long sj, void* stream) {
  return launch<float>(nodes, u, dsdX0, planes, f_e, vol, C, dN, w, shifts,
                       nx, ny, nz, se, sa, sj, stream);
}

extern "C" int femcy_newton_element_f64(const double* nodes, const double* u,
                                        const double* dsdX0, double* planes,
                                        double* f_e, double* vol,
                                        const double* C, const double* dN,
                                        double w, const int* shifts, int nx,
                                        int ny, int nz, long long se,
                                        long long sa, long long sj,
                                        void* stream) {
  return launch<double>(nodes, u, dsdX0, planes, f_e, vol, C, dN, w, shifts,
                        nx, ny, nz, se, sa, sj, stream);
}

// out[0] registers a thread, out[1] local (spilled) bytes a thread.
extern "C" int femcy_newton_element_attributes(int f64, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      f64 ? cudaFuncGetAttributes(&attr, newton_element_kernel<double>)
          : cudaFuncGetAttributes(&attr, newton_element_kernel<float>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
