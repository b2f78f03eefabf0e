// Structured-box internal-force scatter for Hopper, in gather form (M5).
//
// Replaces femcy_tpu/structured.py structured_force_scatter (:476-495), the
// box's Newton-path internal force: element forces f_e (E, 4, 3) of a Kuhn
// box in cell-major order summed into nodal forces (n_nodes, 3) by 6
// orientations x 4 local nodes of corner-shifted dense adds, with no
// scatter (XLA runs them as 24 padded slice adds).
//
// Inputs: f_e[((cell * 6 + o) * 4 + a) * 3 + i], cell = (cx * ny + cy) * nz
// + cz, nc = nx * ny * nz; and the 24 corner shifts (dx, dy, dz), each 0 or
// 1, of local node a of orientation o (the box's corner_delta[kuhn[o][a]]),
// passed by value in the kernel's parameter space.
// Output: out[node * 3 + i] over the (nx + 1) (ny + 1) (nz + 1) grid nodes.
//
// What bounds it on the H100: reading f_e once (72 values a cell: 12.6M
// values, 101 MB in f64 at NX=56) and writing the 3 n_nodes outputs (0.56M
// values).  One add per value read: memory bound.
//
// Design:
// - Gather form, one thread per (grid node, component), one accumulator in
//   a register.  The thread visits the 24 (o, a) shifts, orientation outer,
//   local node inner, and adds value i of cell node - shift where that cell
//   lies in the box.  That is the order in which the plain version's 24
//   slice adds reach each node, from +0, so the result is bit for bit the
//   plain version's, with no atomics, identical from run to run.
// - Staged cell slabs.  A block owns a (y, z) tile of ty x tz grid nodes and
//   marches along x over lx node planes.  Node plane x needs the cells of
//   the slabs cx = x - 1 and x over the tile plus one halo row at -1 in y
//   and z: (ty + 1) (tz + 1) cells a slab.  A ring of three slabs sits in
//   shared memory: while the block sums plane x from slabs x - 1 and x,
//   slab x + 1 is in flight, fetched by 16-byte cp.async copies; after the
//   sum, slab x + 2 replaces slab x - 1.  A z-run of cells is contiguous in
//   f_e (576 bytes a cell in f64), so the copies are coalesced and read
//   every cell in full sectors, once per tile, instead of 24-byte records
//   at a 576-byte stride through L1 and L2.
// - Each cell's row in shared memory is padded by 16 bytes (74 doubles or
//   76 floats, against 72 values), so that lanes of neighbouring z, which
//   read neighbouring cells at the same value, fall on other banks (the
//   unpadded stride of 144 words is 16 modulo 32).
// - Few instructions a step: a thread's copies of a slab, and its 24
//   shared-memory offsets and cell masks, are the same at every step, so
//   they are worked out once, before the march: on an H100, worked out at
//   every step, that arithmetic, not the DRAM, held each block.
// - The tile (ty, tz, lx) comes from the plan (StructuredPlan.force_tile,
//   one per dtype): 6 x 8 nodes in f64 (two blocks an SM), 8 x 8 in f32
//   (three), and lx cut so that the blocks fill the card in one wave.
//   Tiles at the box's edges, and boxes thinner than a tile, mask the
//   cells and nodes that lie outside the box.
// - 64-bit index arithmetic: f_e holds 12.6M values at NX=56, and boxes
//   past about 310^3 cells pass 2^31.

#include <cuda_runtime.h>

namespace {

constexpr int kShifts = 24;  // 6 orientations x 4 local nodes
constexpr int kCellValues = 3 * kShifts;  // 72 values a cell

struct Shifts {
  int d[3 * kShifts];  // (dx, dy, dz) of shift o * 4 + a
};

// a cell's row in shared memory, in values: 72 and 16 bytes of padding
template <typename T>
__host__ __device__ constexpr int cell_stride() {
  return kCellValues + 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// copies of a slab a thread keeps the offsets of in registers: a slab of
// the default tiles takes at most 16 (f64) or 8 (f32) a thread; a larger
// tile takes the rest in a loop
template <typename T>
__host__ __device__ constexpr int kept_copies() {
  return sizeof(T) == 8 ? 16 : 8;
}

template <typename T>
__global__ void structured_force_kernel(const T* __restrict__ f_e,
                                        T* __restrict__ out, const Shifts sh,
                                        int nx, int ny, int nz, int ty,
                                        int tz, int lx, int tiles_z) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int S = cell_stride<T>();
  constexpr int V = 16 / static_cast<int>(sizeof(T));  // values a copy
  constexpr int CH = kCellValues / V;                  // copies a cell
  constexpr int KEPT = kept_copies<T>();
  const int rz = tz + 1;
  const int slab_len = (ty + 1) * rz * S;
  const int tile_y = blockIdx.x / tiles_z;
  const int y0 = tile_y * ty;
  const int z0 = (blockIdx.x - tile_y * tiles_z) * tz;
  const int x0 = blockIdx.y * lx;
  const int x_end = min(x0 + lx, nx + 1);  // node planes [x0, x_end)

  // this thread's node (x0.., y, z) and component i
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int zl = tid % tz;
  const int yl = (tid / tz) % ty;
  const int i = tid / (tz * ty);
  const int y = y0 + yl, z = z0 + zl;
  const bool mine = y <= ny && z <= nz;

  // the cells of a slab that lie in the box: rows cy in [cy_lo, cy_lo +
  // rows), each a contiguous z-run of `run` cells from cz_lo, row_src
  // values apart in f_e
  const int cy_lo = max(y0 - 1, 0);
  const int rows = min(y0 + ty - 1, ny - 1) - cy_lo + 1;
  const int cz_lo = max(z0 - 1, 0);
  const int run = min(z0 + tz - 1, nz - 1) - cz_lo + 1;
  const int row_copies = run * CH;
  const int row_src = nz * kCellValues;
  // where (cy_lo, cz_lo) sits in a slab's (ty + 1, tz + 1) cell grid
  const int dst0 = ((cy_lo - y0 + 1) * rz + (cz_lo - z0 + 1)) * S;

  // This thread's copies of a slab: copy q of row r moves values [q * V,
  // q * V + V) of the row's run into cell q / CH of the row in shared
  // memory.  They are the same for every slab up to its base, so the first
  // KEPT are kept as offsets (-1: none); (r, q) is where the rest start.
  int src_off[KEPT], dst_off[KEPT];
  int r = 0, q = tid;
  while (q >= row_copies) {
    q -= row_copies;
    ++r;
  }
#pragma unroll
  for (int u = 0; u < KEPT; ++u) {
    const int c = q / CH;
    dst_off[u] = r < rows ? dst0 + (r * rz + c) * S + (q - c * CH) * V : -1;
    src_off[u] = r * row_src + q * V;
    if (r < rows) {
      q += nt;
      while (q >= row_copies) {
        q -= row_copies;
        ++r;
      }
    }
  }

  // start copying slab cx into ring buffer b (nothing where the slab is
  // outside the box or past the block's planes); one commit group a slab
  auto fetch = [&](int cx, int b) {
    if (cx >= 0 && cx < nx && cx < x_end) {
      const T* src = f_e + ((static_cast<long long>(cx) * ny + cy_lo) * nz +
                            cz_lo) * kCellValues;
      T* dst = smem + b * slab_len;
#pragma unroll
      for (int u = 0; u < KEPT; ++u)
        if (dst_off[u] >= 0) copy16(dst + dst_off[u], src + src_off[u]);
      for (int rr = r, qq = q; rr < rows;) {
        const int c = qq / CH;
        copy16(dst + dst0 + (rr * rz + c) * S + (qq - c * CH) * V,
               src + rr * row_src + qq * V);
        qq += nt;
        while (qq >= row_copies) {
          qq -= row_copies;
          ++rr;
        }
      }
    }
    commit();
  };

  fetch(x0 - 1, 0);
  fetch(x0, 1);
  fetch(x0 + 1, 2);

  // shift k reads value i of record k of the cell at off[k] in the slab of
  // x - 1 (bit k of lo set) or of x; bit k of yz: that cell's (y, z) lies in
  // the box
  const int self = ((yl + 1) * rz + (zl + 1)) * S + i;
  int off[kShifts];
  unsigned yz = 0, lo = 0;
#pragma unroll
  for (int k = 0; k < kShifts; ++k) {  // k = o * 4 + a
    const int dy = sh.d[3 * k + 1], dz = sh.d[3 * k + 2];
    off[k] = self - (dy * rz + dz) * S + 3 * k;
    if (y - dy >= 0 && y - dy < ny && z - dz >= 0 && z - dz < nz)
      yz |= 1u << k;
    if (sh.d[3 * k]) lo |= 1u << k;
  }
  for (int s = 0; x0 + s < x_end; ++s) {
    wait_pending<1>();  // slabs x - 1 and x have landed
    __syncthreads();
    const int x = x0 + s;
    if (mine) {
      const T* slab_lo = smem + (s % 3) * slab_len;        // cells x - 1
      const T* slab_hi = smem + ((s + 1) % 3) * slab_len;  // cells x
      const unsigned use = yz & ((x >= 1 ? lo : 0u) | (x < nx ? ~lo : 0u));
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < kShifts; ++k) {
        if (use & (1u << k))
          acc += ((lo >> k) & 1u ? slab_lo : slab_hi)[off[k]];
      }
      out[((static_cast<long long>(x) * (ny + 1) + y) * (nz + 1) + z) * 3 +
          i] = acc;
    }
    __syncthreads();  // every thread is done with slab x - 1
    fetch(x + 2, s % 3);
  }
  wait_pending<0>();
}

template <typename T>
int launch(const T* f_e, T* out, const int* shifts, int nx, int ny, int nz,
           int ty, int tz, int lx, void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0) return 0;
  if (ty <= 0 || tz <= 0 || lx <= 0 || 3 * ty * tz > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<unsigned long long>(f_e) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Shifts sh;
  for (int k = 0; k < 3 * kShifts; ++k) {
    if (shifts[k] != 0 && shifts[k] != 1)  // the ring holds one halo cell
      return static_cast<int>(cudaErrorInvalidValue);
    sh.d[k] = shifts[k];
  }
  const int smem = 3 * (ty + 1) * (tz + 1) * cell_stride<T>() *
                   static_cast<int>(sizeof(T));
  auto kernel = structured_force_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles_y = (ny + 1 + ty - 1) / ty;
  const int tiles_z = (nz + 1 + tz - 1) / tz;
  const int chunks = (nx + 1 + lx - 1) / lx;
  if (static_cast<long long>(tiles_y) * tiles_z > 0x7fffffffLL ||
      chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles_y * tiles_z),
                  static_cast<unsigned>(chunks));
  kernel<<<grid, 3 * ty * tz, smem, static_cast<cudaStream_t>(stream)>>>(
      f_e, out, sh, nx, ny, nz, ty, tz, lx, tiles_z);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ``shifts`` is a host array of 72 ints: (dx, dy, dz) for o * 4 + a; the
// tile is (ty, tz) grid nodes marching over lx node planes.
extern "C" int femcy_structured_force_f32(const float* f_e, float* out,
                                          const int* shifts, int nx, int ny,
                                          int nz, int ty, int tz, int lx,
                                          void* stream) {
  return launch<float>(f_e, out, shifts, nx, ny, nz, ty, tz, lx, stream);
}

extern "C" int femcy_structured_force_f64(const double* f_e, double* out,
                                          const int* shifts, int nx, int ny,
                                          int nz, int ty, int tz, int lx,
                                          void* stream) {
  return launch<double>(f_e, out, shifts, nx, ny, nz, ty, tz, lx, stream);
}
