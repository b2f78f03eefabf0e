// Deterministic mixed beam + continuum stiffness scatter for Hopper (M6):
// continuum element stiffnesses and B31 beam stiffnesses -> ELL values of
// the 6-dof union pattern, with no atomics.
//
// Replaces the two indexed adds of femcy_tpu's mixed assembly
// (mixed.py, MixedSystem._assemble_impl: flat.at[targets].add per block),
// which XLA lowers to a sorted or atomic scatter; it is no Pallas kernel.
// femcy_tpu adds every block into one running array, so a slot is
// ((0 + c_1 + c_2 + ...) + b_1 + b_2 + ...): blocks in order, elements in
// order within a block.  This kernel keeps that order.
//
// Layout.  Every node n owns the six dof rows 6n + d (d < 3 the
// translations, d >= 3 the rotations), each W slots wide.  The three
// translation rows share one column list: for each neighbour m in
// ascending order, a run of 3 columns (6m + 0..2), or of 6 (6m + 0..5)
// where a beam couples n and m.  The three rotation rows of a beam node
// share the beam neighbours' runs of 6; those of any other node hold no
// value.
//
// Inputs: a table of the blocks, in femcy_tpu's block order, four int64
// each: the address of the block's element matrices (E_b, edof_b, edof_b)
// with edof_b = npe_b * dm_b, 16-byte aligned; the first global pair id
// of the block; npe_b; and its kind (kTet: npe 4, dm 3; kBeam: B31, npe 2,
// dm 6; 0: any other continuum element, dm 3).  The inverse of the
// element-node maps, made once per pattern on the host: for each node n
// its element-node pairs, global pair id p = offset_b + e * npe_b + a with
// elements_b[e, a] == n, in ascending p (node_ptr/pairs, CSR form; stored
// as ~p where element e names one node twice), and for pair t of that
// list `stride` run starts (positions[t * stride + k], stride a multiple
// of 4): for a continuum pair, k = b the start of local node b's run in
// n's translation row; for a beam pair, k = b the translation start and
// k = 2 + b the rotation start of local node b.  Value (di, b, dj) of
// pair p's band Ke[e, a*dm:(a+1)*dm, :] goes to row 6n + di, slot
// start + dj, where start is the translation run start of b for di < 3
// and its rotation run start for di >= 3.  The band of local pair
// q = p - offset_b begins at q * dm * edof: no division.
//
// Design: one warp owns node n, as in M1 (ell_scatter.cu), kWarps nodes
// a block.
// - It zeroes n's three translation rows in shared memory (3 * W values)
//   and stores zeros straight to its three rotation rows in the output.
//   Only a beam pair has rotation values; it adds them into the output
//   rows themselves.  So a node without a beam (most of them) writes its
//   rotation rows as plain zero stores, and a warp's shared row is half a
//   node's output.
// - It reads its pairs' ids, and the first four run starts of each, 32
//   pairs at a time in coalesced loads (one pair a lane) and hands them
//   out by __shfl_sync.
// - Its pairs come in runs of one block (the list is in block order); the
//   warp looks the block up once per run and walks the run with the
//   block's kind fixed at compile time, so each lane decodes its (di, b,
//   dj) once per run.
// - C3D4 bands go through a ring of kRing bands in the warp's shared
//   memory, filled by cp.async in 16-byte pieces (18 lanes for a band in
//   f64): pair t + kRing - 1's band is in flight while pair t's is added,
//   a value a lane (two rounds of 32).  Each slot also holds its pair's
//   id and starts.  B31 bands (a few a beam node) take the same path with
//   one band in flight.  A generic block (any npe, dm 3) reads its band a
//   value a lane into registers, the next one in flight, and its run
//   starts per pair, M1's way; its instance is built only for a plan that
//   has one.
// The slots of one pair are distinct unless its element names a node
// twice; such pairs (flagged on the host) add their b one at a time.  A
// __syncwarp closes every pair, so each slot takes its contributions in
// ascending p, which is block order and then element order, from 0: bit
// for bit the plain version's sum (one indexed add per block into one
// accumulator), on every run.  At the end the warp copies its translation
// rows out, padding included (0).
//
// Wide rows: three translation rows of more than kRowBytes (W > 1024, at
// 8 bytes a value) are not kept in shared memory.  The host then builds a
// wide plan (int32 run starts) and the warp keeps every sum in the output:
// it zeroes its six rows there and adds each value into its final slot in
// the same order, so the bits are the same.  Any W is accepted.
//
// What bounds it on the H100: bytes in f64.  At 1M C3D4 elements under a
// beam grid it reads the continuum Ke once (1.21 GB) in 288-byte bands in
// node order, the beam matrices (7 MB), the plan (4.2M int32 pairs, 16.9M
// int16 starts) and writes the 6 * 185k * W values (0.43 GB, half of them
// the beamless nodes' zero rotation rows).  Four bands in flight a warp,
// 2 warps a block and 48 registers a thread (40 warps an SM) took it to
// 89% of that bound; one band in flight in registers, or 8 warps a
// block, stayed near 67-74% (tools/m6_designs.py).  In f32 the bands are
// half as long and the per-pair work (ids, starts, fences, adds) bounds
// it at about half the bytes' rate.

#include <cuda_runtime.h>

#include <climits>

// warps (nodes) per block and C3D4 bands in flight a warp;
// tools/m6_designs.py builds other values
#ifndef FEMCY_M6_WARPS
#define FEMCY_M6_WARPS 2
#endif
#ifndef FEMCY_M6_RING
#define FEMCY_M6_RING 4
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = FEMCY_M6_WARPS;
// the longest three translation rows kept in shared memory, in bytes at 8
// bytes a value (SHARED_ROW_BYTES in kernels/mixed_scatter.py): W up to
// 1024, the first design's limit; rows of 48 KB would leave 4 warps an SM
constexpr int kRowBytes = 24 * 1024;
// block kinds (KIND_* in kernels/mixed_scatter.py); kind 0 is a generic
// continuum block
constexpr int kTet = 1, kBeam = 2;
// a generic band takes at most this many rounds of 32 values
constexpr int kMaxRounds = 8;
// C3D4 bands in flight a warp, in its ring in shared memory
constexpr int kRing = FEMCY_M6_RING;
static_assert(kRing >= 2 && (kRing & (kRing - 1)) == 0,
              "the ring holds a beam band and its slots go by a mask");
// the values of a C3D4 band
constexpr int kTetBand = 36;

// the first four run starts of a pair, in one load; a start is picked by
// its key (S::key(k) for start k)
template <typename Index>
struct Starts;
template <>
struct Starts<short> {
  using V = unsigned long long;
  __device__ static int key(int k) { return 16 * k; }
  __device__ static int at(V s, int key) {
    return static_cast<int>((s >> key) & 0xffffu);
  }
  __device__ static V shfl(V s, int src) { return __shfl_sync(kFull, s, src); }
};
template <>
struct Starts<int> {
  using V = uint4;
  __device__ static int key(int k) { return k; }
  __device__ static int at(const V& s, int key) {
    return static_cast<int>(key == 0 ? s.x : key == 1 ? s.y
                            : key == 2 ? s.z : s.w);
  }
  __device__ static V shfl(const V& s, int src) {
    return V{__shfl_sync(kFull, s.x, src), __shfl_sync(kFull, s.y, src),
             __shfl_sync(kFull, s.z, src), __shfl_sync(kFull, s.w, src)};
  }
};

// Kernel arguments that stay in the constant bank.
template <typename T, typename Index>
struct Args {
  const long long* blocks;
  int n_blocks;
  const long long* node_ptr;
  const int* pairs;
  const Index* positions;
  int stride;
  T* out;
  long long n_nodes;
  int width;
  int warp_bytes;
};

// the bytes of a warp's ring: kRing C3D4 bands (or one B31 band) and
// their metas
template <typename T>
__host__ __device__ constexpr int ring_bytes() {
  return kRing * (kTetBand * static_cast<int>(sizeof(T)) + 32);
}
static_assert(kWarps * (kRowBytes + ring_bytes<double>()) <= 227 * 1024,
              "a block of the longest rows passes the shared memory of an SM");

// The warp's window on its node's pair list (from lo, np pairs): 32 pairs,
// one a lane, with each pair's id and first four run starts.  Every call
// is warp-uniform.
template <typename T, typename Index>
struct Window {
  using S = Starts<Index>;
  const Args<T, Index>& args;
  int lo, np;
  int first;  // list index of lane 0's pair
  int id;
  typename S::V starts;

  __device__ void fetch(int t) {
    first = t;
    const int lane = threadIdx.x & 31;
    if (t + lane < np) {
      id = __ldg(args.pairs + lo + t + lane);
      starts = __ldg(reinterpret_cast<const typename S::V*>(
          args.positions + static_cast<long long>(lo + t + lane)
          * args.stride));
    } else {
      id = 0;
      starts = typename S::V{};
    }
  }
  // pair t's stored id (the window moves on when t passes it)
  __device__ int id_at(int t) {
    if (t >= first + 32) fetch(t);
    return __shfl_sync(kFull, id, t - first);
  }
};

__device__ __forceinline__ int decode(int id) { return id < 0 ? ~id : id; }

// The lane's index, hidden from the compiler: what a run derives from it
// is then computed in the run, not hoisted out of the node's loop, where
// every kind's values would stay live in registers at once.
__device__ __forceinline__ int opaque_lane() {
  int lane = threadIdx.x & 31;
  asm volatile("" : "+r"(lane));
  return lane;
}

// 16 bytes from global to shared memory, asynchronously (cp.async), and
// its group fences
__device__ __forceinline__ void copy16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// a pair in the ring: its stored id and first four run starts
template <typename Index>
struct alignas(16) Meta {
  int id;
  typename Starts<Index>::V starts;
};

// The pairs t, t + 1, ... of one block of fixed kind (NPE, DM), from t up
// to the first pair of the list past the block (p >= end); returns that
// pair's list index.  ke is the block's element matrices, off its first
// pair id; trans the node's translation rows, dst its six rows in the
// output (the rotation rows 3 * width on); ring the warp's ring of bands.
// K bands are in flight: pair t + K - 1's band is copied into the ring
// while pair t's is added (K = 1 for a beam: a few pairs a beam node).
template <typename T, typename Index, int NPE, int DM, int K>
__device__ int fixed_run(Window<T, Index>& win, int t, int end, const T* ke,
                         int off, T* trans, T* dst, unsigned char* ring) {
  using S = Starts<Index>;
  constexpr int kEdof = NPE * DM;
  constexpr int kBand = DM * kEdof;
  constexpr int kSlot = kBand * static_cast<int>(sizeof(T));
  static_assert(kSlot % 16 == 0, "a band is whole 16-byte copies");
  static_assert(K * kSlot <= kRing * kTetBand * static_cast<int>(sizeof(T)),
                "the ring holds K bands");
  // a band is copied in 16-byte pieces, kC rounds of 32 lanes, and added a
  // value a lane, kR rounds
  constexpr int kPieces = kSlot / 16;
  constexpr int kC = (kPieces + 31) / 32;
  constexpr int kR = (kBand + 31) / 32;
  const int lane = opaque_lane();
  const int width = win.args.width;
  // the lane's value r * 32 + lane of a band, (di, b, dj) -> its slot
  // without the start (a rotation value's counted from the translation
  // rows' start) and the key of the start it takes
  int base[kR], key[kR];
  bool act[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    act[r] = r * 32 + lane < kBand;
    const int j = act[r] ? r * 32 + lane : 0;
    const int di = j / kEdof, col = j - di * kEdof;
    const int b = col / DM, dj = col - b * DM;
    base[r] = di * width + dj;
    key[r] = S::key(di >= 3 ? 2 + b : b);
  }
  Meta<Index>* meta =
      reinterpret_cast<Meta<Index>*>(ring + kRing * kTetBand * sizeof(T));
  const int t0 = t;
  // the next pair to copy, and the run's end once a copy finds it
  int next = t, stop = INT_MAX;
  auto copy_next = [&]() {
    if (next < stop) {
      const int id = next < win.np ? win.id_at(next) : 0;
      if (next < win.np && decode(id) < end) {
        const int slot = (next - t0) % K;
        const char* src = reinterpret_cast<const char*>(
            ke + static_cast<long long>(decode(id) - off) * kBand);
        const unsigned to = static_cast<unsigned>(
            __cvta_generic_to_shared(ring + slot * kSlot));
#pragma unroll
        for (int r = 0; r < kC; ++r) {
          const int piece = r * 32 + lane;
          if (piece < kPieces) copy16(to + piece * 16, src + piece * 16);
        }
        const typename S::V st = S::shfl(win.starts, next - win.first);
        if (lane == 0) meta[slot] = Meta<Index>{id, st};
        ++next;
      } else {
        stop = next;
      }
    }
    // one group a call, copies or none, so pair t's is the (t - t0)-th
    commit_copies();
  };
  // value r into its slot: translation values in trans, rotation values
  // (a beam's di >= 3) in the output's rotation rows
  auto add = [&](int r, const T& x, const typename S::V& st) {
    const int slot = base[r] + S::at(st, key[r]);
    if (DM == 6 && key[r] >= S::key(2)) dst[slot] += x;
    else trans[slot] += x;
  };
#pragma unroll
  for (int i = 0; i + 1 < K; ++i) copy_next();
  for (;; ++t) {
    copy_next();
    if (t == next) return t;  // nothing was copied for t: the run is over
    wait_copies<K - 1>();
    __syncwarp();  // every lane's pieces and lane 0's meta
    const int slot = (t - t0) % K;
    const Meta<Index> m = meta[slot];
    const T* band = reinterpret_cast<const T*>(ring + slot * kSlot) + lane;
    T v[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) v[r] = act[r] ? band[r * 32] : T(0);
    if (m.id >= 0) {
#pragma unroll
      for (int r = 0; r < kR; ++r)
        if (act[r]) add(r, v[r], m.starts);
    } else {
      // the element names a node twice: two b share a slot, so add the
      // b in ascending order (b is the start's index mod NPE)
      for (int bb = 0; bb < NPE; ++bb) {
#pragma unroll
        for (int r = 0; r < kR; ++r)
          if (act[r] && (key[r] == S::key(bb) || key[r] == S::key(bb + NPE)))
            add(r, v[r], m.starts);
        __syncwarp();
      }
    }
    __syncwarp();  // the slot is free for the copy K - 1 pairs on
  }
}

// The same for a generic continuum block (dm 3, npe <= 28 at runtime):
// a value a lane, the run starts read per pair, M1's way.
template <typename T, typename Index>
__device__ int generic_run(Window<T, Index>& win, int t, int end,
                           const T* ke, int off, int npe, T* trans) {
  const int lane = opaque_lane();
  const int width = win.args.width;
  const int edof = npe * 3;
  const int band = 3 * edof;
  int base[kMaxRounds], bsel[kMaxRounds];
  bool act[kMaxRounds];
#pragma unroll
  for (int r = 0; r < kMaxRounds; ++r) {
    const int j = r * 32 + lane;
    act[r] = j < band;
    const int jj = act[r] ? j : 0;
    const int di = jj / edof, col = jj - di * edof;
    bsel[r] = col / 3;
    base[r] = di * width + col - bsel[r] * 3;
  }
  auto load = [&](int tt, int id, T* v, int& pos) {
    const T* src = ke + static_cast<long long>(decode(id) - off) * band + lane;
#pragma unroll
    for (int r = 0; r < kMaxRounds; ++r)
      v[r] = act[r] ? __ldg(src + r * 32) : T(0);
    pos = lane < npe
        ? static_cast<int>(__ldg(win.args.positions + static_cast<long long>(
              win.lo + tt) * win.args.stride + lane))
        : 0;
  };
  int id = win.id_at(t);
  T v[kMaxRounds];
  int pos;
  load(t, id, v, pos);
  for (;;) {
    const int id_next = t + 1 < win.np ? win.id_at(t + 1) : INT_MIN;
    const bool more = id_next != INT_MIN && decode(id_next) < end;
    T w[kMaxRounds];
    int pos_next = 0;
    if (more) load(t + 1, id_next, w, pos_next);
    int slot[kMaxRounds];
#pragma unroll
    for (int r = 0; r < kMaxRounds; ++r)
      slot[r] = base[r] + __shfl_sync(kFull, pos, bsel[r]);
    if (id >= 0) {
#pragma unroll
      for (int r = 0; r < kMaxRounds; ++r)
        if (act[r]) trans[slot[r]] += v[r];
    } else {
      for (int bb = 0; bb < npe; ++bb) {
#pragma unroll
        for (int r = 0; r < kMaxRounds; ++r)
          if (act[r] && bsel[r] == bb) trans[slot[r]] += v[r];
        __syncwarp();
      }
    }
    __syncwarp();
    ++t;
    if (!more) return t;
    id = id_next;
    pos = pos_next;
#pragma unroll
    for (int r = 0; r < kMaxRounds; ++r) v[r] = w[r];
  }
}

// kWide: the sums are kept in the output (int32 run starts); otherwise
// each warp keeps its translation rows in shared memory, after its ring.
// kAnyGeneric: the plan has a generic block.
template <typename T, typename Index, bool kWide, bool kAnyGeneric>
__global__ void __launch_bounds__(kWarps * 32)
mixed_row_kernel(const __grid_constant__ Args<T, Index> args) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (n >= args.n_nodes) return;  // the whole warp
  const int len = 3 * args.width;
  T* dst = args.out + n * 2 * len;
  // the warp's shared memory: its ring (bands, then metas), then its
  // translation rows
  unsigned char* ring = smem + warp * args.warp_bytes;
  T* trans = kWide ? dst : reinterpret_cast<T*>(ring + ring_bytes<T>());
  for (int i = lane; i < len; i += 32) {
    trans[i] = T(0);
    dst[len + i] = T(0);
  }
  // the plan holds fewer than 2^31 pairs
  const int lo = static_cast<int>(__ldg(args.node_ptr + n));
  Window<T, Index> win{args, lo,
                       static_cast<int>(__ldg(args.node_ptr + n + 1)) - lo};
  win.fetch(0);
  __syncwarp();

  int b = 0;
  for (int t = 0; t < win.np;) {
    const int p = decode(win.id_at(t));
    // the block of pair p: the last one whose first pair is <= p
    const long long* blocks = args.blocks;
    while (b + 1 < args.n_blocks && __ldg(blocks + (b + 1) * 4 + 1) <= p) ++b;
    const T* ke = reinterpret_cast<const T*>(__ldg(blocks + b * 4));
    const int off = static_cast<int>(__ldg(blocks + b * 4 + 1));
    const int end = b + 1 < args.n_blocks
        ? static_cast<int>(__ldg(blocks + (b + 1) * 4 + 1)) : INT_MAX;
    const int kind = static_cast<int>(__ldg(blocks + b * 4 + 3));
    if (kind == kTet) {
      t = fixed_run<T, Index, 4, 3, kRing>(win, t, end, ke, off, trans, dst,
                                           ring);
    } else if (kind == kBeam) {
      t = fixed_run<T, Index, 2, 6, 1>(win, t, end, ke, off, trans, dst,
                                       ring);
    } else if constexpr (kAnyGeneric) {
      t = generic_run<T, Index>(win, t, end, ke, off,
                                static_cast<int>(__ldg(blocks + b * 4 + 2)),
                                trans);
    } else {
      __trap();  // the host launches the generic instance for such a plan
    }
  }

  if (kWide) return;  // the sums are in place
  __syncwarp();
  for (int i = lane; i < len; i += 32) dst[i] = trans[i];
}

template <typename T, typename Index, bool kWide, bool kAnyGeneric>
cudaError_t instance(int width, void** kernel, int* smem) {
  *kernel = reinterpret_cast<void*>(
      mixed_row_kernel<T, Index, kWide, kAnyGeneric>);
  // each warp's ring and translation rows, rows padded to 16 bytes
  const int rows = kWide ? 0 : (3 * width * static_cast<int>(sizeof(T)) + 15)
      / 16 * 16;
  *smem = kWarps * (ring_bytes<T>() + rows);
  if (*smem > 48 * 1024)
    return cudaFuncSetAttribute(*kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                *smem);
  return cudaSuccess;
}

// the instance for (wide, generic), its shared memory and row stride
template <typename T>
cudaError_t pick(int wide, int generic, int width, void** kernel, int* smem) {
  if (wide)
    return generic ? instance<T, int, true, true>(width, kernel, smem)
                   : instance<T, int, true, false>(width, kernel, smem);
  return generic ? instance<T, short, false, true>(width, kernel, smem)
                 : instance<T, short, false, false>(width, kernel, smem);
}

template <typename T>
int launch(const long long* blocks, int n_blocks, int generic,
           const long long* node_ptr, const int* pairs, const void* positions,
           int stride, int wide, T* out, long long n_nodes, int width,
           void* stream) {
  if (n_nodes <= 0) return 0;
  if (n_blocks < 1 || stride < 4 || stride > 32 || stride % 4 != 0 ||
      width < 1 || (!wide && 3 * width * 8 > kRowBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  void* kernel = nullptr;
  int smem = 0;
  cudaError_t err = pick<T>(wide, generic, width, &kernel, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warp_bytes = smem / kWarps;
  const unsigned grid =
      static_cast<unsigned>((n_nodes + kWarps - 1) / kWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    const Args<T, int> args{blocks, n_blocks, node_ptr, pairs,
                            static_cast<const int*>(positions), stride, out,
                            n_nodes, width, warp_bytes};
    void* argv[] = {const_cast<Args<T, int>*>(&args)};
    err = cudaLaunchKernel(kernel, dim3(grid), dim3(kWarps * 32), argv, smem,
                           s);
  } else {
    const Args<T, short> args{blocks, n_blocks, node_ptr, pairs,
                              static_cast<const short*>(positions), stride,
                              out, n_nodes, width, warp_bytes};
    void* argv[] = {const_cast<Args<T, short>*>(&args)};
    err = cudaLaunchKernel(kernel, dim3(grid), dim3(kWarps * 32), argv, smem,
                           s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int femcy_mixed_scatter_f32(const long long* blocks, int n_blocks,
                                       int generic, const long long* node_ptr,
                                       const int* pairs, const void* positions,
                                       int stride, int wide, float* out,
                                       long long n_nodes, int width,
                                       void* stream) {
  return launch<float>(blocks, n_blocks, generic, node_ptr, pairs, positions,
                       stride, wide, out, n_nodes, width, stream);
}

extern "C" int femcy_mixed_scatter_f64(const long long* blocks, int n_blocks,
                                       int generic, const long long* node_ptr,
                                       const int* pairs, const void* positions,
                                       int stride, int wide, double* out,
                                       long long n_nodes, int width,
                                       void* stream) {
  return launch<double>(blocks, n_blocks, generic, node_ptr, pairs, positions,
                        stride, wide, out, n_nodes, width, stream);
}

// What the instance for (f64, wide, generic) at this width takes:
// out[0] registers a thread, out[1] local (spilled) bytes a thread, out[2]
// warps a block, out[3] blocks resident on an SM, out[4] dynamic shared
// bytes a block.
extern "C" int femcy_mixed_scatter_attributes(int f64, int wide, int generic,
                                              int width, int* out) {
  void* kernel = nullptr;
  int smem = 0;
  cudaError_t err = f64 ? pick<double>(wide, generic, width, &kernel, &smem)
                        : pick<float>(wide, generic, width, &kernel, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kWarps * 32, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = kWarps;
  out[3] = blocks;
  out[4] = smem;
  return 0;
}
