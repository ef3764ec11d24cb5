// A short sum of T x T tile products into target tiles, spread over the
// card's SMs: the routine selinv_step.cu and band_update.cu instantiate,
// each with its own operand addressing.
//
//   u = sum_{q < n} A(q) op(B(q)),   op(B) = B (NN) or B^T (NT),
//
// for row-major T x T tiles in device memory, T in {8, 16, 32, 64}.  The
// launch plan comes from the wrapper (kernels/tile_sum.py::tile_sum_plan):
//   - the output is split into S x S sub-tiles, S = min(T, 32), each its own
//     block, so a 64 x 64 target is four blocks;
//   - the pairs of one sub-tile go to a thread-block cluster of CL blocks
//     (the cluster-dimension launch attribute, CL <= 4); rank r takes the
//     contiguous, ordered run q = r * per .. min((r + 1) * per, n) - 1, and
//     a rank past the target's pairs contributes a zero partial;
//   - each rank leaves its S x S partial in its own shared memory; after
//     cluster.sync() rank 0 adds ranks 1..CL-1 to its own, in rank order,
//     through distributed shared memory (cluster.map_shared_rank), and
//     stores the tile; a second cluster.sync() keeps every rank's shared
//     memory alive until rank 0 has read it.
// One launch, no workspace, no atomics: the same bits on every run, and a
// batch element's bits are its unbatched launch's (only pointers differ).
//
// A block is kSumThreads threads, thread (ty, tx) = (tid / 8, tid % 8)
// holding MR x MC outputs of the sub-tile in plain FP32 FMAs (no TF32):
// rows ty + NTY i, NTY = kSumThreads / 8; columns tx * MC + j (NN) or
// tx + 8 j (NT).  Operands are
// staged with cp.async into a double buffer: a pair's copies are in flight
// while the pair before it is multiplied.  A is staged as it is (S rows of
// T, k contiguous), B as it is too: T rows of S columns (NN), or S rows of T
// (NT, k contiguous); the row pads of 4 floats put the rows a warp reads at
// one k on distinct banks.  Each element sums k = 0..T-1 of its rank's pairs
// in order, then the ranks in order.
#pragma once

#include <cooperative_groups.h>

#include "tile.cuh"

namespace stiles {

constexpr int kSumThreads = 128;
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kMaxClusterNonPortable = 16;   // the largest, with the attribute

template <int T>
struct SumShape {
    static constexpr int S = T < 32 ? T : 32;         // sub-tile edge
    static constexpr int NS = T / S;                  // sub-tiles per edge
    static constexpr int NTY = kSumThreads / 8;       // thread rows
    static constexpr int MC = S / 8;                  // columns per thread
    static constexpr int MR = S > NTY ? S / NTY : 1;  // rows per thread
    static constexpr int ACTIVE = 8 * (S / MR);       // threads holding outputs
    static constexpr int LDK = T + 4;                 // row of a k-contiguous stage
    static constexpr int LDN = S + 4;                 // row of an NN B stage
    static_assert(ACTIVE <= kSumThreads, "sub-tile too large for the block");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// 4 bytes, through L1 (cp.async.cg takes 16 only): for rows whose stride
// or offset is not a multiple of 16 bytes.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The two halves of a cluster barrier (cluster.sync() is both at once): a
// thread's writes before its arrive, to global or to distributed shared
// memory, are visible to every thread of the cluster after its wait (the
// arrive releases, the wait acquires).  Every thread arrives and then
// waits, in turn.
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// ROWS x COLS floats from src (row stride LDS) to dst (row stride LDD), 16
// bytes a copy, neighbouring threads on neighbouring addresses.
template <int ROWS, int COLS, int LDD, int LDS>
__device__ __forceinline__ void stage_rows(float* dst, const float* src) {
    constexpr int kC4 = COLS / 4, kVec = ROWS * kC4;
#pragma unroll
    for (int p = 0; p < (kVec + kSumThreads - 1) / kSumThreads; ++p) {
        const int v = threadIdx.x + p * kSumThreads;
        if (v < kVec) {
            const int r = v / kC4, c = 4 * (v % kC4);
            cp_async16(dst + r * LDD + c, src + r * LDS + c);
        }
    }
}

// acc += A op(B) over the staged operands of one pair.
template <int T, bool NT>
__device__ __forceinline__ void mma_sub(float (&acc)[SumShape<T>::MR][SumShape<T>::MC],
                                        const float* As, const float* Bs, int ty, int tx) {
    using Sh = SumShape<T>;
    constexpr int MR = Sh::MR, MC = Sh::MC, LDK = Sh::LDK, LDN = Sh::LDN;
#pragma unroll 4
    for (int k0 = 0; k0 < T; k0 += 4) {
        float a[MR][4], b[4][MC];
#pragma unroll
        for (int i = 0; i < MR; ++i) ld_vec<4>(a[i], As + (ty + Sh::NTY * i) * LDK + k0);
        if constexpr (NT) {
#pragma unroll
            for (int j = 0; j < MC; ++j) {
                float v[4];
                ld_vec<4>(v, Bs + (tx + 8 * j) * LDK + k0);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) b[kk][j] = v[kk];
            }
        } else {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) ld_vec<MC>(b[kk], Bs + (k0 + kk) * LDN + tx * MC);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < MR; ++i)
#pragma unroll
                for (int j = 0; j < MC; ++j) acc[i][j] = fmaf(a[i][kk], b[kk][j], acc[i][j]);
    }
}

// acc += sum_{q = lo .. lo + len - 1} A(q) op(B(q)) over the S x S sub-tile
// at (r0, c0), the pairs in order, a pair's copies in flight while the pair
// before it is multiplied.  As and Bs are two stages each, of S * LDK floats
// (A) and S * LDK (NT) or T * LDN (NN) floats (B).  Every thread of the
// block calls it with the same lo and len.  It does not synchronise after
// the last pair: the caller does before it stages into the buffers again.
template <int T, bool NT, typename FA, typename FB>
__device__ __forceinline__ void sum_pairs(float (&acc)[SumShape<T>::MR][SumShape<T>::MC], FA A,
                                          FB B, int lo, int len, int r0, int c0, float* As,
                                          float* Bs) {
    using Sh = SumShape<T>;
    constexpr int S = Sh::S, LDK = Sh::LDK, LDN = Sh::LDN;
    constexpr int A_STAGE = S * LDK, B_STAGE = NT ? S * LDK : T * LDN;
    const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
    const bool active = threadIdx.x < Sh::ACTIVE;
    auto stage = [&](int q, int buf) {
        stage_rows<S, T, LDK, T>(As + buf * A_STAGE, A(q) + static_cast<size_t>(r0) * T);
        if constexpr (NT) {
            stage_rows<S, T, LDK, T>(Bs + buf * B_STAGE, B(q) + static_cast<size_t>(c0) * T);
        } else {
            stage_rows<T, S, LDN, T>(Bs + buf * B_STAGE, B(q) + c0);
        }
        cp_async_commit();
    };
    if (len > 0) stage(lo, 0);
    if (len > 1) stage(lo + 1, 1);
    for (int p = 0; p < len; ++p) {
        if (p + 1 < len) {
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();  // every thread's copies of pair p have landed
        if (active) mma_sub<T, NT>(acc, As + (p & 1) * A_STAGE, Bs + (p & 1) * B_STAGE, ty, tx);
        if (p + 2 < len) {
            __syncthreads();  // buffer p & 1 is free again
            stage(lo + p + 2, p & 1);
        }
    }
}

// u = sum_{q < n} A(q) op(B(q)) for the target tile at u, this block's
// sub-tile blockIdx.x / CL and cluster rank blockIdx.x % CL, pairs in runs
// of `per` a rank (the plan: CL * per >= n).  A and B map q to a tile
// address.  Every thread of every block of the cluster must call it.
template <int T, bool NT, typename FA, typename FB>
__device__ __forceinline__ void cluster_tile_sum(FA A, FB B, int n, int per, float* u) {
    using Sh = SumShape<T>;
    constexpr int S = Sh::S, MR = Sh::MR, MC = Sh::MC, LDK = Sh::LDK, LDN = Sh::LDN;
    __shared__ __align__(16) float As[2 * S * LDK];
    __shared__ __align__(16) float Bs[2 * (NT ? S * LDK : T * LDN)];
    __shared__ __align__(16) float part[kSumThreads * MR * MC];
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    const int cl = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int sub = blockIdx.x / cl;
    const int r0 = sub / Sh::NS * S, c0 = sub % Sh::NS * S;
    const int lo = min(rank * per, n), len = min(lo + per, n) - lo;
    const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
    const bool active = threadIdx.x < Sh::ACTIVE;

    float acc[MR][MC];
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < MC; ++j) acc[i][j] = 0.f;
    sum_pairs<T, NT>(acc, A, B, lo, len, r0, c0, As, Bs);

    // the cluster's partials, each thread's MR x MC outputs contiguous in
    // `part` at its own slot: rank 0's thread reads the slot its twin wrote
    float* slot = part + threadIdx.x * MR * MC;
    if (rank > 0 && active) {
#pragma unroll
        for (int i = 0; i < MR; ++i) st_vec<MC>(slot + i * MC, acc[i]);
    }
    cluster.sync();
    if (rank == 0 && active) {
        for (int r = 1; r < cl; ++r) {
            const float* rs = cluster.map_shared_rank(slot, r);
#pragma unroll
            for (int i = 0; i < MR; ++i) {
                float v[MC];
                ld_vec<MC>(v, rs + i * MC);
#pragma unroll
                for (int j = 0; j < MC; ++j) acc[i][j] += v[j];
            }
        }
#pragma unroll
        for (int i = 0; i < MR; ++i) {
            float* row = u + static_cast<size_t>(r0 + ty + Sh::NTY * i) * T + c0;
            if constexpr (NT) {
#pragma unroll
                for (int j = 0; j < MC; ++j) row[tx + 8 * j] = acc[i][j];
            } else {
                st_vec<MC>(row + tx * MC, acc[i]);
            }
        }
    }
    cluster.sync();  // rank 0 has read every rank's partial
}

// Launch `kernel` on grid, kSumThreads threads a block and `smem` bytes of
// dynamic shared memory, in clusters of `cl` blocks along x.
template <typename... P, typename... Args>
cudaError_t launch_cluster(void (*kernel)(P...), dim3 grid, int cl, size_t smem,
                           cudaStream_t stream, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kSumThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The plan's checks common to both entry points: S is the sub-tile edge
// the kernels are built for, the cluster a portable size, and the ranks'
// runs cover the longest target's max_pairs pairs.
inline bool plan_ok(int t, int sub, int cl, int per, int max_pairs) {
    return sub == (t < 32 ? t : 32) && cl >= 1 && cl <= kMaxCluster && per >= 1 &&
           static_cast<long long>(cl) * per >= max_pairs;
}

}  // namespace stiles
