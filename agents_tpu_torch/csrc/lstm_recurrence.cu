// The reset-masked LSTM recurrence on an NVIDIA Hopper card: one kernel
// launch per time step, forward and backward.
//
// What it replaces. The JAX package writes this loop as flax's `nn.scan`
// (a `lax.scan`) over `MaskedLSTMCell` (agents_tpu/networks/
// lstm_networks.py), no Pallas kernel; the port's plain version is the
// Python loop of `_MaskedLSTMUnroll` (agents_tpu_torch/networks/
// lstm_networks.py), some eleven device ops a forward step and eight a
// backward step, each a host dispatch. Here each step is one launch, and
// the cell's arithmetic runs in the epilogue of the recurrent product.
//
// What bounds it. R2D2's step is a [64, 512] x [512, 2048] product in
// float32 (134 MFLOP, about 2 us at the card's 67 TFLOP/s of FMA) with
// the 4 MB recurrent weight read from L2, and the next step waits for it.
// A block owns a tile of rows and hidden units: 128 blocks of 32 rows x 8
// units at 64 rows, one per SM, each moving 128 KB of operands into shared
// memory. That copy bounds the step: measured on the card, one SM takes in
// about 30-35 GB/s from L2 however few blocks run, by cp.async, plain
// loads or the tensor memory accelerator alike, so 128 KB is some 4 us
// before any FMA. The operands stream through a ring of chunks of k, six
// deep, so the product of one chunk overlaps the copies of the next; each
// thread keeps a 4 x 4 tile of sums in registers, two 16-byte shared loads
// for every 16 FMAs. Groups of threads split k and add their sums in
// shared memory in a fixed order, so a result does not depend on timing.
// The backward's product reduces over 4H = 2048: a cluster of four blocks
// splits it, each block reading a quarter of k, and adds the four sums
// through distributed shared memory. No tensor cores: operands and sums
// are float32, FMA on the CUDA cores. A kernel that kept W on chip across
// steps would move half the bytes a step; it needs a grid-wide barrier
// every step and is not this one.
//
// Forward step t, for the units J of a block and each of its rows:
//   gates = keep_t * (h_{t-1} @ W[cols(J)]^T) + gates_x[:, t, cols(J)]
//   c_t = sigmoid(f) * (keep_t * c_{t-1}) + sigmoid(i) * tanh(g)
//   h_t = sigmoid(o) * tanh(c_t)
// h_t goes into the output [B, T, H] (the next step reads h_{t-1} there)
// and c_t into the carry. When a gradient is needed the step also keeps
// sigmoid(i, f, o) with tanh(g), the masked c_{t-1} and h_{t-1}, and
// tanh(c_t), each [T, B, .].
//
// Backward step t, for the units J of a block: d_h_{t-1}[:, J] =
// keep_t * (d_gates_t @ W[:, J]) (W^T's rows, so both products read
// k-contiguous rows), then step t-1's cell gradient and its four gate
// gradients for J. A first launch forms step T-1's gate gradients from the
// gradients of the outputs and of the final carry; the launch for t = 0
// writes the gradients of the initial carry instead.
//
// Interface: plain C, no torch headers. The caller allocates every buffer
// and passes PyTorch's stream; each function returns 0 or the CUDA error of
// the first call that failed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

// The launch parameters, set once per unroll (the C functions' arguments,
// so outside the unnamed namespace).
struct Forward {
  const float* gates_x;  // [B, T, 4H]: input products and bias
  const float* keep;     // [B, T]: 0 where the step is FIRST
  const float* w;        // [4H, H]: recurrent weight, gates i, f, g, o
  const float* h0;       // [B, H]
  const float* c0;       // [B, H]
  float* out;            // [B, T, H]
  float* c;              // [B, H]: c after each step
  float* h;              // [B, H]: h of the last step
  float* acts;           // [T, B, 4H] or null: sigmoid i, f, tanh g, sigmoid o
  float* cells;          // [T, B, H]: keep_t * c_{t-1}
  float* hiddens;        // [T, B, H]: keep_t * h_{t-1}
  float* tanh_c;         // [T, B, H]
  int rows, size, steps, device;
};

struct Backward {
  const float* keep;     // [B, T]
  const float* wt;       // [H, 4H]: the recurrent weight transposed
  const float* d_out;    // [B, T, H]
  const float* d_c;      // [B, H]: gradient of the final c
  const float* d_h;      // [B, H]: gradient of the final h
  const float* acts;     // the forward's saved activations
  const float* cells;
  const float* tanh_c;
  float* d_gates;        // [T, B, 4H]
  float* dc;             // [B, H]: the running gradient of c
  float* d_c0;           // [B, H]
  float* d_h0;           // [B, H]
  int rows, size, steps, device;
};

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
// Chunks of k in flight: six of a 64-row step's eight, in 104 KB of shared
// memory a block, under the 110 KB at which the backward's clusters of four
// all fit the card at once (above it, only 30 of R2D2's 32 do).
constexpr int kStages = 6;
// A backward step splits k (4H) over a cluster of this many blocks.
constexpr int kSplit = 4;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A block's product out[r, n] = sum_k A[r, k] * B[n, k] over BR rows and BN
// columns, both operands k-contiguous rows in global memory. Chunks of KC
// = KS * KG values of k stream through a ring of kStages stages in shared
// memory, every thread copying with cp.async. The threads form KS groups
// that split each chunk in 16-byte slots; a thread of group g sums rows
// tr + i * BR / 4 and columns tn + j * BN / 4 (i, j < 4), so two 16-byte
// shared loads feed 16 FMAs.
template <int BR, int BN, int KS, int KG>
struct Tile {
  static constexpr int P = (BR / 4) * (BN / 4);  // threads of a group
  static_assert(P * KS == kThreads, "a tile takes every thread");
  static_assert(KG % 4 == 0, "k goes in 16-byte slots");
  static constexpr int KC = KS * KG;
  // Row pitch in shared memory: 4 banks apart where one group fills a
  // warp, 8 where two groups share one (their slots lie 4 banks apart).
  static constexpr int KCP = KC + (P >= 32 ? 4 : 8);
  static constexpr int STAGE = (BR + BN) * KCP;
  static constexpr int RED = KS * BR * BN;
  static constexpr int SMEM = kStages * STAGE > RED ? kStages * STAGE : RED;
  static constexpr int BYTES = SMEM * 4;
  static_assert(BYTES <= 110 * 1024, "clusters of four fit the card");
};

// Sums of the block's product over k in [k0, k1), reduced over the groups:
// afterwards red[(g * BR + r) * BN + n] holds group g's partial sum, for
// the caller to add in order. a_row(r) / b_row(n) give a row's start, or
// null past the edge (read as zeros); when vec, k0 % 4 == 0, K % 4 == 0
// and rows are 16-byte aligned.
template <int BR, int BN, int KS, int KG, class ARow, class BRow>
__device__ __forceinline__ void tile_product(float* smem, int k0, int k1,
                                             bool vec, const float* safe,
                                             ARow a_row, BRow b_row) {
  using T = Tile<BR, BN, KS, KG>;
  const int tid = threadIdx.x;
  const int g = tid / T::P, tr = (tid % T::P) / (BN / 4), tn = tid % (BN / 4);
  const int chunks = k1 > k0 ? (k1 - k0 + T::KC - 1) / T::KC : 0;

  auto load = [&](int chunk, int stage) {
    float* base = smem + stage * T::STAGE;  // A's rows, then B's
    const int kc = k0 + chunk * T::KC;
    if (vec) {
      constexpr int V = T::KC / 4;
      for (int e = tid; e < (BR + BN) * V; e += kThreads) {
        const int row = e / V, kk = (e % V) * 4, k = kc + kk;
        const float* src = row < BR ? a_row(row) : b_row(row - BR);
        const bool ok = src != nullptr && k < k1;
        cp_async16(base + row * T::KCP + kk, ok ? src + k : safe, ok);
      }
    } else {
      for (int e = tid; e < (BR + BN) * T::KC; e += kThreads) {
        const int row = e / T::KC, kk = e % T::KC, k = kc + kk;
        const float* src = row < BR ? a_row(row) : b_row(row - BR);
        const bool ok = src != nullptr && k < k1;
        cp_async4(base + row * T::KCP + kk, ok ? src + k : safe, ok);
      }
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load(s, s);
    cp_async_commit();
  }
  for (int chunk = 0; chunk < chunks; ++chunk) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = chunk + kStages - 1;
    if (next < chunks) load(next, next % kStages);
    cp_async_commit();
    const float* as = smem + (chunk % kStages) * T::STAGE;
    const float* bs = as + BR * T::KCP;
#pragma unroll
    for (int v = 0; v < KG / 4; ++v) {
      const int k = (v * KS + g) * 4;
      float4 x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[i] = *reinterpret_cast<const float4*>(
            as + (tr + i * (BR / 4)) * T::KCP + k);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        y[j] = *reinterpret_cast<const float4*>(
            bs + (tn + j * (BN / 4)) * T::KCP + k);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
          acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
          acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
          acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every stage read: the ring becomes the sums
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      smem[(g * BR + tr + i * (BR / 4)) * BN + tn + j * (BN / 4)] =
          acc[i][j];
  __syncthreads();
}

// Group g's partial sums of column n of row r, added in the order of g.
template <int BR, int BN, int KS>
__device__ __forceinline__ float reduced(const float* red, int r, int n) {
  float s = 0.0f;
#pragma unroll
  for (int g = 0; g < KS; ++g) s += red[(g * BR + r) * BN + n];
  return s;
}

// Block (x, y) owns units [x * UB, (x + 1) * UB) of rows [y * BR, ...); its
// product's columns are gate-major: column q * UB + u is gate q of unit u.
// What the cell needs besides the product is read before it, so that its
// latency hides behind the product's. `vec`: 16-byte copies (H % 4 == 0
// and h0, the output and W 16-byte aligned).
template <int BR, int UB, int KS, int KG>
__global__ void __launch_bounds__(kThreads)
    forward_step(const Forward p, const int t, const bool vec) {
  constexpr int BN = 4 * UB;
  constexpr int ITEMS = (BR * UB + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) float smem[];
  const int H = p.size, B = p.rows, T = p.steps;
  const int r0 = blockIdx.y * BR, j0 = blockIdx.x * UB;
  const float* h_prev = t == 0 ? p.h0 : p.out + (long long)(t - 1) * H;
  const long long h_pitch = t == 0 ? H : (long long)T * H;

  float kp[ITEMS] = {}, gx[ITEMS][4] = {}, c_prev[ITEMS] = {},
        h_in[ITEMS] = {};
#pragma unroll
  for (int n = 0; n < ITEMS; ++n) {
    const int item = threadIdx.x + n * kThreads;
    const int row = r0 + item / UB, j = j0 + item % UB;
    if (item >= BR * UB || row >= B || j >= H) continue;
    const long long bt = (long long)row * T + t, idx = (long long)row * H + j;
    kp[n] = p.keep[bt];
#pragma unroll
    for (int q = 0; q < 4; ++q) gx[n][q] = p.gates_x[bt * 4 * H + q * H + j];
    c_prev[n] = t == 0 ? p.c0[idx] : p.c[idx];
    if (p.acts != nullptr) h_in[n] = h_prev[row * h_pitch + j];
  }

  auto a_row = [&](int r) -> const float* {
    return r0 + r < B ? h_prev + (r0 + r) * h_pitch : nullptr;
  };
  auto b_row = [&](int n) -> const float* {
    const int j = j0 + n % UB;
    return j < H ? p.w + (long long)((n / UB) * H + j) * H : nullptr;
  };
  tile_product<BR, BN, KS, KG>(smem, 0, H, vec, p.w, a_row, b_row);

#pragma unroll
  for (int n = 0; n < ITEMS; ++n) {
    const int item = threadIdx.x + n * kThreads;
    const int r = item / UB, u = item % UB, row = r0 + r, j = j0 + u;
    if (item >= BR * UB || row >= B || j >= H) continue;
    const long long bt = (long long)row * T + t;
    float a[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      a[q] = fmaf(kp[n], reduced<BR, BN, KS>(smem, r, q * UB + u), gx[n][q]);
    const float ig = sigmoid(a[0]), fg = sigmoid(a[1]), gg = tanhf(a[2]),
                og = sigmoid(a[3]);
    const long long idx = (long long)row * H + j;
    const float c_in = kp[n] * c_prev[n];
    const float c_new = fg * c_in + ig * gg;
    const float tc = tanhf(c_new);
    const float h_new = og * tc;
    p.out[bt * H + j] = h_new;
    p.c[idx] = c_new;
    if (t == T - 1) p.h[idx] = h_new;
    if (p.acts != nullptr) {
      const long long s4 = ((long long)t * B + row) * 4 * H + j;
      p.acts[s4] = ig;
      p.acts[s4 + H] = fg;
      p.acts[s4 + 2 * H] = gg;
      p.acts[s4 + 3 * H] = og;
      const long long s1 = ((long long)t * B + row) * H + j;
      p.cells[s1] = c_in;
      p.hiddens[s1] = kp[n] * h_in[n];
      p.tanh_c[s1] = tc;
    }
  }
}

// What step s's gate gradients of one unit of one row need from the
// forward, read before they are formed.
struct Saved {
  float ig, fg, gg, og, tc, cell, d_out;
};

__device__ __forceinline__ Saved saved(const Backward& p, int s, int row,
                                       int j) {
  const int H = p.size, B = p.rows;
  const long long s4 = ((long long)s * B + row) * 4 * H + j;
  const long long s1 = ((long long)s * B + row) * H + j;
  return {p.acts[s4],
          p.acts[s4 + H],
          p.acts[s4 + 2 * H],
          p.acts[s4 + 3 * H],
          p.tanh_c[s1],
          p.cells[s1],
          p.d_out[((long long)row * p.steps + s) * H + j]};
}

// Step s's gate gradients of unit j of `row`, from the gradient of its h
// carried back from step s + 1 (dh, before the output's share) and of its
// c (dc, before the share through h): writes them and the step's total
// gradient of c.
__device__ __forceinline__ void gate_grads(const Backward& p, int s, int row,
                                           int j, const Saved& v, float dh,
                                           float dc) {
  const int H = p.size, B = p.rows;
  const long long s4 = ((long long)s * B + row) * 4 * H + j;
  dh = dh + v.d_out;
  dc = dc + dh * (v.og * (1.0f - v.tc * v.tc));
  p.d_gates[s4] = dc * (v.gg * v.ig * (1.0f - v.ig));
  p.d_gates[s4 + H] = dc * (v.cell * v.fg * (1.0f - v.fg));
  p.d_gates[s4 + 2 * H] = dc * (v.ig * (1.0f - v.gg * v.gg));
  p.d_gates[s4 + 3 * H] = dh * (v.tc * v.og * (1.0f - v.og));
  p.dc[(long long)row * H + j] = dc;
}

__global__ void __launch_bounds__(kThreads) backward_start(const Backward p) {
  const int H = p.size, B = p.rows, T = p.steps;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)B * H) return;
  const int row = idx / H, j = idx % H;
  gate_grads(p, T - 1, row, j, saved(p, T - 1, row, j), p.d_h[idx],
             p.d_c[idx]);
}

// Block (x, y, z) owns units [x * UB, (x + 1) * UB) of rows [y * BR, ...)
// and the z-th of kSplit slices of k; the kSplit blocks of a cluster add
// their sums through distributed shared memory, block z taking rows
// [z * BR / kSplit, (z + 1) * BR / kSplit) of the tile to its epilogue.
template <int BR, int UB, int KS, int KG>
__global__ void __cluster_dims__(1, 1, kSplit) __launch_bounds__(kThreads)
    backward_step(const Backward p, const int t) {
  constexpr int ROWS = BR / kSplit;
  constexpr int ITEMS = (ROWS * UB + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int H = p.size, B = p.rows, T = p.steps, G = 4 * H;
  const int r0 = blockIdx.y * BR, j0 = blockIdx.x * UB;

  float kp[ITEMS] = {}, f_t[ITEMS] = {}, dc[ITEMS] = {};
  Saved v[ITEMS] = {};
#pragma unroll
  for (int n = 0; n < ITEMS; ++n) {
    const int item = threadIdx.x + n * kThreads;
    const int row = r0 + rank * ROWS + item / UB, j = j0 + item % UB;
    if (item >= ROWS * UB || row >= B || j >= H) continue;
    const long long idx = (long long)row * H + j;
    kp[n] = p.keep[(long long)row * T + t];
    f_t[n] = p.acts[((long long)t * B + row) * G + H + j];
    dc[n] = p.dc[idx];
    if (t > 0) v[n] = saved(p, t - 1, row, j);
  }

  const int slice = (G / kSplit + 3) / 4 * 4;
  const int k0 = rank * slice, k1 = min(G, k0 + slice);
  const float* dg = p.d_gates + (long long)t * B * G;
  auto a_row = [&](int r) -> const float* {
    return r0 + r < B ? dg + (long long)(r0 + r) * G : nullptr;
  };
  auto b_row = [&](int n) -> const float* {
    return j0 + n < H ? p.wt + (long long)(j0 + n) * G : nullptr;
  };
  tile_product<BR, UB, KS, KG>(smem, k0, k1, true, p.wt, a_row, b_row);
  // This block's sums, over its groups, into the first BR x UB floats.
  for (int item = threadIdx.x; item < BR * UB; item += kThreads)
    smem[item] = reduced<BR, UB, KS>(smem, item / UB, item % UB);
  cluster.sync();

#pragma unroll
  for (int n = 0; n < ITEMS; ++n) {
    const int item = threadIdx.x + n * kThreads;
    const int r = rank * ROWS + item / UB, u = item % UB;
    const int row = r0 + r, j = j0 + u;
    if (item >= ROWS * UB) continue;
    float acc = 0.0f;
#pragma unroll
    for (int z = 0; z < kSplit; ++z)
      acc += cluster.map_shared_rank(smem, z)[r * UB + u];
    if (row >= B || j >= H) continue;
    const long long idx = (long long)row * H + j;
    const float dc_next = dc[n] * (f_t[n] * kp[n]);
    const float dh = acc * kp[n];
    if (t == 0) {
      p.d_h0[idx] = dh;
      p.d_c0[idx] = dc_next;
    } else {
      gate_grads(p, t - 1, row, j, v[n], dh, dc_next);
    }
  }
  cluster.sync();  // no block leaves while another reads its sums
}

// A grid of this many blocks fills an H100 (132 SMs), one block each.
constexpr int kFillBlocks = 128;

inline unsigned blocks(int n, int per) { return (n + per - 1) / per; }

inline bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// Runs `launch` on `device`, giving the caller's device back after.
template <class F>
int on_device(int device, F launch) {
  int previous = 0;
  cudaError_t e = cudaGetDevice(&previous);
  if (e == cudaSuccess && previous != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rc = launch();
  if (previous != device) cudaSetDevice(previous);
  return rc;
}

template <int BR, int UB, int KS, int KG>
int forward_steps(const Forward& q, cudaStream_t st) {
  constexpr int bytes = Tile<BR, 4 * UB, KS, KG>::BYTES;
  auto kernel = forward_step<BR, UB, KS, KG>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  const bool vec = q.size % 4 == 0 && aligned16(q.h0) && aligned16(q.out) &&
                   aligned16(q.w);
  const dim3 grid(blocks(q.size, UB), blocks(q.rows, BR));
  for (int t = 0; t < q.steps && e == cudaSuccess; ++t) {
    kernel<<<grid, kThreads, bytes, st>>>(q, t, vec);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}

template <int BR, int UB, int KS, int KG>
int backward_steps(const Backward& q, cudaStream_t st) {
  constexpr int bytes = Tile<BR, UB, KS, KG>::BYTES;
  auto kernel = backward_step<BR, UB, KS, KG>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) {
    backward_start<<<blocks(q.rows * q.size, kThreads), kThreads, 0, st>>>(
        q);
    e = cudaGetLastError();
  }
  const dim3 grid(blocks(q.size, UB), blocks(q.rows, BR), kSplit);
  for (int t = q.steps - 1; t >= 0 && e == cudaSuccess; --t) {
    kernel<<<grid, kThreads, bytes, st>>>(q, t);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// All T forward steps of `p`, in order, on `stream`. A block owns 32 rows x
// 8 units (k in 4 groups of 16 a chunk) where that grid fills the card, as
// R2D2's 64 and 256 rows at H = 512 do; else 16 rows x 4 units (16 groups
// of 4), as the CartPole nets' 64 rows at H = 40 take.
int lstm_forward(const Forward* p, void* stream) {
  const Forward q = *p;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(q.device, [&]() -> int {
    if (blocks(q.size, 8) * blocks(q.rows, 32) >= kFillBlocks)
      return forward_steps<32, 8, 4, 16>(q, st);
    return forward_steps<16, 4, 16, 4>(q, st);
  });
}

// The backward of `p`'s unroll: the start at step T-1, then the steps
// T-1 down to 0, on `stream`. A block owns 32 rows x 32 units and a
// quarter of k (4 groups of 16 a chunk): 2 x 16 x 4 = 128 blocks at 64 rows
// and H = 512.
int lstm_backward(const Backward* p, void* stream) {
  const Backward q = *p;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(q.device, [&]() -> int {
    return backward_steps<32, 32, 4, 16>(q, st);
  });
}

}  // extern "C"
