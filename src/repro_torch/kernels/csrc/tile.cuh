// Device functions shared by the potrf, trsm, band-Cholesky, solve-panel,
// band-solve and selected-inversion kernels.
//
// The owner-layout routines run kThreads threads per block over float32
// T x T tiles, T in {8, 16, 32, 64}.  A tile held in registers is spread over
// the block in the "owner layout": thread (ty, tx) = (tid / NT, tid % NT)
// holds the M x M block of elements (ty*M + r, tx*M + s), r, s < M, so each
// thread reads and writes M contiguous floats of a row at once.  A tile
// product C += A B^T stages A and B in shared memory transposed
// (contraction index major), where every owner reads its M rows of A and M
// columns of B as one vector per contraction step.  The blocked one-tile
// routines (factorize_smem, substitute_right) take the block's thread count
// as a template parameter and work on tiles in shared memory.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace stiles {

constexpr int kThreads = 256;

template <int T>
struct Tile {
    static constexpr int NT = T < 16 ? T : 16;  // owner threads per dimension
    static constexpr int M = T / NT;            // elements per owner per dimension
    static constexpr int LDK = T + 4;           // row of a staged (transposed) tile
    static_assert(NT * NT <= kThreads, "tile too large for the block");
};

template <int T>
using Acc = float[Tile<T>::M][Tile<T>::M];

template <int T>
__device__ __forceinline__ bool owns_tile() {
    return threadIdx.x < Tile<T>::NT * Tile<T>::NT;
}

template <int T>
__device__ __forceinline__ int owner_row(int r) {
    return threadIdx.x / Tile<T>::NT * Tile<T>::M + r;
}

template <int T>
__device__ __forceinline__ int owner_col(int s) {
    return threadIdx.x % Tile<T>::NT * Tile<T>::M + s;
}

// M contiguous floats, M-aligned, as one vector access.
template <int M>
__device__ __forceinline__ void ld_vec(float (&v)[M], const float* p) {
    if constexpr (M == 4) {
        const float4 x = *reinterpret_cast<const float4*>(p);
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else if constexpr (M == 2) {
        const float2 x = *reinterpret_cast<const float2*>(p);
        v[0] = x.x; v[1] = x.y;
    } else {
        v[0] = p[0];
    }
}

template <int M>
__device__ __forceinline__ void st_vec(float* p, const float (&v)[M]) {
    if constexpr (M == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else if constexpr (M == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    } else {
        p[0] = v[0];
    }
}

template <int T>
__device__ __forceinline__ void zero_acc(Acc<T>& acc) {
#pragma unroll
    for (int r = 0; r < Tile<T>::M; ++r)
#pragma unroll
        for (int s = 0; s < Tile<T>::M; ++s) acc[r][s] = 0.f;
}

// One thread's share of two T x T tiles on their way from device memory to
// shared memory: float4 v covers row v % T, columns 4 (v / T) .. +3, so the
// 32 lanes of a warp store 32 consecutive rows of the transposed tile
// (distinct banks).
template <int T>
struct Stage {
    static constexpr int kVec = T * T / 4;
    static constexpr int kPer = (kVec + kThreads - 1) / kThreads;
    float4 a[kPer], b[kPer];

    __device__ __forceinline__ void load(const float* A, const float* B) {
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
            const int v = threadIdx.x + p * kThreads;
            if (v < kVec) {
                const int o = (v % T) * T + 4 * (v / T);
                a[p] = *reinterpret_cast<const float4*>(A + o);
                b[p] = *reinterpret_cast<const float4*>(B + o);
            }
        }
    }

    // Staged float4 p into dst: transposed, dst[c * LDK + r] = X[r, c], or
    // as it is, dst[r * LDK + c] = X[r, c].
    static __device__ __forceinline__ void put(float* dst, const float4& x, int v,
                                               bool transpose) {
        constexpr int LDK = Tile<T>::LDK;
        const int r = v % T, c = 4 * (v / T);
        if (transpose) {
            dst[c * LDK + r] = x.x; dst[(c + 1) * LDK + r] = x.y;
            dst[(c + 2) * LDK + r] = x.z; dst[(c + 3) * LDK + r] = x.w;
        } else {
            *reinterpret_cast<float4*>(dst + r * LDK + c) = x;
        }
    }

    // Either operand transposed or not (see put).
    __device__ __forceinline__ void store(float* As, float* Bs, bool ta, bool tb) const {
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
            const int v = threadIdx.x + p * kThreads;
            if (v < kVec) {
                put(As, a[p], v, ta);
                put(Bs, b[p], v, tb);
            }
        }
    }
};

// acc += A B^T from the staged (transposed) operands.
template <int T>
__device__ __forceinline__ void mma_staged(Acc<T>& acc, const float* As, const float* Bs) {
    constexpr int NT = Tile<T>::NT, M = Tile<T>::M, LDK = Tile<T>::LDK;
    if (!owns_tile<T>()) return;
    const float* pa = As + threadIdx.x / NT * M;
    const float* pb = Bs + threadIdx.x % NT * M;
#pragma unroll 8
    for (int k = 0; k < T; ++k) {
        float av[M], bv[M];
        ld_vec<M>(av, pa + k * LDK);
        ld_vec<M>(bv, pb + k * LDK);
#pragma unroll
        for (int r = 0; r < M; ++r)
#pragma unroll
            for (int s = 0; s < M; ++s) acc[r][s] = fmaf(av[r], bv[s], acc[r][s]);
    }
}

// A tile operand of gemm_sum: a row-major T x T tile in device memory,
// taken as it is or transposed.
struct Op {
    const float* p;
    bool t;
};

// acc += sum_{q < n} op(A(q)) op(B(q)) for row-major T x T tiles in device
// memory, op(X) = X^T where the operand says so, staged through the shared
// buffers As and Bs (T * LDK floats each).  mma_staged needs
// As[k, r] = op(A)[r, k] and Bs[k, c] = op(B)[k, c], so A is stored
// transposed unless op transposes it and B the other way round.  The next
// pair's loads are in flight while the current pair is multiplied.  n must
// be the same in every thread: every thread of the block calls it, and it
// synchronises the block twice per pair.
template <int T, typename FA, typename FB>
__device__ void gemm_sum(Acc<T>& acc, int n, FA A, FB B, float* As, float* Bs) {
    if (n <= 0) return;
    Stage<T> st;
    Op oa = A(0), ob = B(0);
    st.load(oa.p, ob.p);
    for (int q = 0; q < n; ++q) {
        __syncthreads();  // the staging buffers are free
        st.store(As, Bs, !oa.t, ob.t);
        __syncthreads();
        if (q + 1 < n) {
            oa = A(q + 1);
            ob = B(q + 1);
            st.load(oa.p, ob.p);
        }
        mma_staged<T>(acc, As, Bs);
    }
}

// Store an owner-layout tile row-major (leading dimension T).
template <int T>
__device__ __forceinline__ void store_tile(float* dst, const Acc<T>& a) {
    constexpr int M = Tile<T>::M;
    if (!owns_tile<T>()) return;
#pragma unroll
    for (int r = 0; r < M; ++r) st_vec<M>(dst + owner_row<T>(r) * T + owner_col<T>(0), a[r]);
}

// ---------------------------------------------------------------------------
// Blocked one-tile routines on shared memory: the Cholesky factorization of
// potrf.cu and the band-Cholesky sweep, and the right-substitution of trsm.cu
// and the sweep.  A tile sits in shared memory with rows padded to T + 1
// floats (LD), and is walked in panels of NB = min(T, 16) columns, so the
// block barriers a tile needs do not grow with T: 8 at T = 64 for either.
// NT is the block's thread count; every thread of the block calls them.
// ---------------------------------------------------------------------------

template <int T>
struct Panel {
    static constexpr int NB = T < 16 ? T : 16;   // panel width
    static constexpr int LD = T + 1;             // padded row in shared memory
};

// A row-major T x T tile of device memory into S (row stride LD), read
// through L2 (ld.global.cg): another block of a cluster may have written it
// during the launch, and the SM's L1 could hold an older copy.  Every load
// is in flight before the first store to S.  Does not synchronise.
template <int T, int NT>
__device__ __forceinline__ void stage_padded(float* S, const float* src) {
    constexpr int LD = Panel<T>::LD, kVec = T * T / 4, kPer = (kVec + NT - 1) / NT;
    float4 x[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
        const int v = threadIdx.x + p * NT;
        if (v < kVec) x[p] = __ldcg(reinterpret_cast<const float4*>(src) + v);
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
        const int v = threadIdx.x + p * NT;
        if (v < kVec) {
            float* row = S + (4 * v / T) * LD + 4 * v % T;
            row[0] = x[p].x; row[1] = x[p].y; row[2] = x[p].z; row[3] = x[p].w;
        }
    }
}

// The lower triangle of S (row stride LD) to dst row-major, zeros above the
// diagonal; true if this thread's share is not finite.  Does not
// synchronise.
template <int T, int NT>
__device__ __forceinline__ bool store_lower(float* dst, const float* S) {
    constexpr int LD = Panel<T>::LD;
    bool bad = false;
    for (int v = threadIdx.x; v < T * T; v += NT) {
        const int r = v / T, c = v % T;
        const float x = c <= r ? S[r * LD + c] : 0.f;
        dst[v] = x;
        bad |= !isfinite(x);
    }
    return bad;
}

// Cholesky of the SPD tile in S (row stride LD), in place: the lower
// triangle becomes L; above the diagonal S is left as scratch, never read.
// Only the lower triangle of the input is read.  For each panel of NB
// columns:
//   (a) the NB x NB diagonal block is factored by a warp, lane i holding row
//       i in registers, the pivot and each scaled column entry broadcast by
//       __shfl_sync: no block barrier inside;
//   (b) the rows below it (X L11^T = A21) ride along in the same loop:
//       lanes 16..31 of warp w hold rows 16 w .. 16 w + 15 below the block,
//       and every warp factors the block alike to have its broadcasts, so
//       the panel is one pass of NB steps;
//   (c) the block updates the trailing lower triangle, A22 -= L21 L21^T, a
//       thread a 4 x 4 micro-tile of it;
// with one barrier after (a, b) and one after (c).  Plain fp32 FMA (no
// TF32), the pivot's reciprocal square root by rsqrtf, as the TPU kernel's
// rsqrt.  A non-positive pivot gives NaN (rsqrt of a negative number, or
// 0 * inf), which then reaches every later column through the updates.
// Returns after a block barrier.
template <int T, int NT>
__device__ void factorize_smem(float* S) {
    constexpr int NB = Panel<T>::NB, LD = Panel<T>::LD;
    static_assert((T - NB + 15) / 16 <= NT / 32, "too few warps for the rows below a panel");
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll 1
    for (int k0 = 0; k0 < T; k0 += NB) {
        const int k1 = k0 + NB;
        // (a, b) the panel: warp w's lanes 0..NB-1 hold the diagonal block's
        // rows and lanes 16..31 rows k1 + 16 w + 0..15 below it; every warp
        // factors the diagonal block alike and solves its own rows with it
        const int below = lane - 16 + 16 * warp;           // row k1 + below
        const bool diag_row = lane < NB;
        const bool below_row = lane >= 16 && k1 + below < T;
        if (warp == 0 || 16 * warp < T - k1) {
            const int row = diag_row ? k0 + lane : k1 + below;
            float r[NB];
#pragma unroll
            for (int c = 0; c < NB; ++c)
                r[c] = diag_row || below_row ? S[row * LD + k0 + c] : 0.f;
            const int i = diag_row ? lane : NB;            // the row's place in the panel
            float pv = r[0];   // the next pivot, on its own lane
#pragma unroll
            for (int k = 0; k < NB; ++k) {
                const float dinv = rsqrtf(__shfl_sync(0xffffffffu, pv, k));
                const float lk = r[k] * dinv;              // L[row, k] for i >= k
                r[k] = i >= k ? lk : r[k];
                // lane k + 1 updates its pivot with its own lk, the value
                // the update below gives its r[k + 1], so the chain from one
                // pivot to the next does not wait for the shuffle of lk
                if (k + 1 < NB) pv = fmaf(-lk, lk, r[k + 1]);
#pragma unroll
                for (int m = k + 1; m < NB; ++m) {
                    const float lmk = __shfl_sync(0xffffffffu, lk, m);
                    // selects, not branches: divergent branches around
                    // register updates cost a warp reconvergence each
                    r[m] = i >= m ? fmaf(-lk, lmk, r[m]) : r[m];
                }
            }
            if ((diag_row && warp == 0) || below_row) {
#pragma unroll
                for (int c = 0; c < NB; ++c)
                    if (c <= i) S[row * LD + k0 + c] = r[c];
            }
        }
        __syncthreads();
        if (k1 == T) break;
        // (c) the trailing lower triangle: A22 -= L21 L21^T, 4 x 4 micro-tiles
        const int nmb = (T - k1) / 4;
        for (int idx = tid; idx < nmb * (nmb + 1) / 2; idx += NT) {
            int bi = static_cast<int>(0.5f * (sqrtf(8.f * idx + 1.f) - 1.f));   // row-major
            bi += (bi + 1) * (bi + 2) / 2 <= idx;                               // lower tile
            bi -= bi * (bi + 1) / 2 > idx;
            const int bm = idx - bi * (bi + 1) / 2;
            const int i0 = k1 + 4 * bi, m0 = k1 + 4 * bm;
            float acc[4][4];
#pragma unroll
            for (int p = 0; p < 4; ++p)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[p][q] = S[(i0 + p) * LD + m0 + q];
#pragma unroll
            for (int c = 0; c < NB; ++c) {
                float li[4], lm[4];
#pragma unroll
                for (int p = 0; p < 4; ++p) {
                    li[p] = S[(i0 + p) * LD + k0 + c];
                    lm[p] = S[(m0 + p) * LD + k0 + c];
                }
#pragma unroll
                for (int p = 0; p < 4; ++p)
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(-li[p], lm[q], acc[p][q]);
            }
#pragma unroll
            for (int p = 0; p < 4; ++p)
#pragma unroll
                for (int q = 0; q < 4; ++q) S[(i0 + p) * LD + m0 + q] = acc[p][q];
        }
        __syncthreads();
    }
}

// The reciprocals of the factored tile's diagonal, dinv[j] = 1 / L[j, j],
// the pivots of substitute_right.  Does not synchronise.
template <int T, int NT>
__device__ __forceinline__ void store_pivots(float* dinv, const float* L) {
    for (int j = threadIdx.x; j < T; j += NT) dinv[j] = 1.f / L[j * (Panel<T>::LD + 1)];
}

// Solve X L^T = A, row by row, for up to kSubChunk rows held in X (row
// stride LD; rows nrows .. nrows rounded up to 4 are zero): L lower
// triangular at row stride LD, only its strict lower triangle read, and
// dinv its pivots' reciprocals.  Per panel of NB columns:
//   (a) the panel: a thread a row, x_c = a_c / L[c, c] and then every later
//       entry of the panel updated, each L entry read as a broadcast (every
//       thread reads the same word), so there is no shuffle chain;
//   (b) the trailing update X[:, j1:] -= X[:, panel] L[j1:, panel]^T over
//       the whole block, a thread a 4 x 4 micro-tile;
// with one barrier after each.  Returns after a block barrier.
constexpr int kSubChunk = 64;

template <int T, int NT>
__device__ void solve_rows_smem(float* X, int nrows, const float* L, const float* dinv) {
    constexpr int NB = Panel<T>::NB, LD = Panel<T>::LD;
    const int tid = threadIdx.x;
    const int nmr = (nrows + 3) / 4;
#pragma unroll 1
    for (int j0 = 0; j0 < T; j0 += NB) {
        const int j1 = j0 + NB;
        for (int r = tid; r < nrows; r += NT) {
            float x[NB];
#pragma unroll
            for (int c = 0; c < NB; ++c) x[c] = X[r * LD + j0 + c];
#pragma unroll
            for (int c = 0; c < NB; ++c) {
                x[c] *= dinv[j0 + c];
#pragma unroll
                for (int m = c + 1; m < NB; ++m)
                    x[m] = fmaf(-x[c], L[(j0 + m) * LD + j0 + c], x[m]);
            }
#pragma unroll
            for (int c = 0; c < NB; ++c) X[r * LD + j0 + c] = x[c];
        }
        __syncthreads();
        if (j1 == T) break;
        const int nmc = (T - j1) / 4;
        for (int idx = tid; idx < nmr * nmc; idx += NT) {
            const int i0 = 4 * (idx / nmc), m0 = j1 + 4 * (idx % nmc);
            float acc[4][4];
#pragma unroll
            for (int p = 0; p < 4; ++p)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[p][q] = X[(i0 + p) * LD + m0 + q];
#pragma unroll
            for (int c = 0; c < NB; ++c) {
                float xi[4], lm[4];
#pragma unroll
                for (int p = 0; p < 4; ++p) {
                    xi[p] = X[(i0 + p) * LD + j0 + c];
                    lm[p] = L[(m0 + p) * LD + j0 + c];
                }
#pragma unroll
                for (int p = 0; p < 4; ++p)
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(-xi[p], lm[q], acc[p][q]);
            }
#pragma unroll
            for (int p = 0; p < 4; ++p)
#pragma unroll
                for (int q = 0; q < 4; ++q) X[(i0 + p) * LD + m0 + q] = acc[p][q];
        }
        __syncthreads();
    }
}

// Solve X L^T = A for nrows independent rows of T floats: row r is read from
// src(r) (through L2, as stage_padded reads) and written to dst(r); they may
// alias, since a chunk of kSubChunk rows is read whole into the shared buffer
// X (kSubChunk * LD floats) before any of it is written.  L and dinv as
// solve_rows_smem takes them.  Returns true if this thread's share of the
// solution is not finite.  Every thread of the block calls it; X is still in
// use when it returns, so the caller synchronises before reusing it.
template <int T, int NT, typename Src, typename Dst>
__device__ bool substitute_right(float* X, const float* L, const float* dinv, int nrows,
                                 Src src, Dst dst) {
    constexpr int LD = Panel<T>::LD, V = T / 4;
    bool bad = false;
#pragma unroll 1
    for (int r0 = 0; r0 < nrows; r0 += kSubChunk) {
        if (r0 > 0) __syncthreads();   // the chunk before is stored
        const int n = min(kSubChunk, nrows - r0), n4 = (n + 3) / 4 * 4;
        constexpr int kPer = (kSubChunk * V + NT - 1) / NT;
        float4 x[kPer];   // every load in flight before the first store
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
            const int v = threadIdx.x + p * NT, r = v / V, c = 4 * (v % V);
            x[p] = r < n ? __ldcg(reinterpret_cast<const float4*>(src(r0 + r) + c))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
            const int v = threadIdx.x + p * NT;
            if (v < n4 * V) {
                float* row = X + v / V * LD + 4 * (v % V);
                row[0] = x[p].x; row[1] = x[p].y; row[2] = x[p].z; row[3] = x[p].w;
            }
        }
        __syncthreads();
        solve_rows_smem<T, NT>(X, n, L, dinv);
        for (int v = threadIdx.x; v < n * V; v += NT) {
            const int r = v / V, c = 4 * (v % V);
            const float* row = X + r * LD + c;
            const float4 x = make_float4(row[0], row[1], row[2], row[3]);
            *reinterpret_cast<float4*>(dst(r0 + r) + c) = x;
            bad |= !(isfinite(x.x) && isfinite(x.y) && isfinite(x.z) && isfinite(x.w));
        }
    }
    return bad;
}

// Solve X L^T = A (BACK false) or X L = A (BACK true) in place for R <= 8
// rows held in X (row stride ldx): the few-rows form of solve_rows_smem, for
// the band-solve sweeps, where a row of X is one right-hand-side column of
// L y = b (BACK false) or of L^T y = b (BACK true).  L lower triangular at
// row stride ldl, only its strict lower triangle read, and dinv its pivots'
// reciprocals; ldx and ldl are multiples of 4 and X, L 16-byte aligned.
// BACK false walks the panels of NB columns left to right,
// x_c = (a_c - sum_{l < c} x_l L[c, l]) / L[c, c]; BACK true right to left,
// x_c = (a_c - sum_{l > c} x_l L[l, c]) / L[c, c].  Per panel:
//   (a) the panel: a thread a row, L read as broadcasts;
//   (b) the update of the columns the panel feeds, an element (BACK false:
//       right of the panel, L's row segment read as float4) or four
//       neighbouring elements (BACK true: left of it, L's rows read as
//       float4) a thread, the panel's NB products in order: R rows are too
//       few for solve_rows_smem's 4 x 4 micro-tiles to keep the block busy;
// with one barrier after each, 7 at T = 64.  Every thread of the block calls
// it; returns after a block barrier.
template <int T, int NT, int R, bool BACK>
__device__ void solve_few_rows(float* X, int ldx, const float* L, int ldl, const float* dinv) {
    constexpr int NB = Panel<T>::NB;
    static_assert(R <= NT && NB % 4 == 0, "a thread a row, float4 panels");
    const int tid = threadIdx.x;
#pragma unroll 1
    for (int s = 0; s < T; s += NB) {
        const int j0 = BACK ? T - NB - s : s;
        if (tid < R) {
            float* row = X + tid * ldx + j0;
            float x[NB];
#pragma unroll
            for (int c = 0; c < NB; ++c) x[c] = row[c];
#pragma unroll
            for (int u = 0; u < NB; ++u) {
                const int c = BACK ? NB - 1 - u : u;
                x[c] *= dinv[j0 + c];
#pragma unroll
                for (int m = 0; m < NB; ++m) {
                    if (BACK ? m < c : m > c)
                        x[m] = fmaf(-x[c], BACK ? L[(j0 + c) * ldl + j0 + m]
                                                : L[(j0 + m) * ldl + j0 + c], x[m]);
                }
            }
#pragma unroll
            for (int c = 0; c < NB; ++c) row[c] = x[c];
        }
        __syncthreads();
        const int n = BACK ? j0 : T - j0 - NB;   // columns the panel feeds
        if (n == 0) break;
        if constexpr (!BACK) {
            for (int idx = tid; idx < R * n; idx += NT) {
                const int r = idx % R, i = j0 + NB + idx / R;
                const float* xr = X + r * ldx + j0;
                const float* li = L + i * ldl + j0;
                float acc = X[r * ldx + i];
#pragma unroll
                for (int c = 0; c < NB; c += 4) {
                    const float4 xv = *reinterpret_cast<const float4*>(xr + c);
                    const float4 lv = *reinterpret_cast<const float4*>(li + c);
                    acc = fmaf(-xv.x, lv.x, acc);
                    acc = fmaf(-xv.y, lv.y, acc);
                    acc = fmaf(-xv.z, lv.z, acc);
                    acc = fmaf(-xv.w, lv.w, acc);
                }
                X[r * ldx + i] = acc;
            }
        } else {
            for (int idx = tid; idx < R * n / 4; idx += NT) {
                const int r = idx % R, i = 4 * (idx / R);
                const float* xr = X + r * ldx + j0;
                float4* dst = reinterpret_cast<float4*>(X + r * ldx + i);
                float4 acc = *dst;
#pragma unroll
                for (int c = 0; c < NB; ++c) {
                    const float xc = xr[c];
                    const float4 lv = *reinterpret_cast<const float4*>(L + (j0 + c) * ldl + i);
                    acc.x = fmaf(-xc, lv.x, acc.x);
                    acc.y = fmaf(-xc, lv.y, acc.y);
                    acc.z = fmaf(-xc, lv.z, acc.z);
                    acc.w = fmaf(-xc, lv.w, acc.w);
                }
                *dst = acc;
            }
        }
        __syncthreads();
    }
}

// One row-major T x T tile of device memory into shared memory with row
// stride Tile<T>::LDK, as it is or transposed (dst[c * LDK + r] = src[r, c]).
// Every thread of the block calls it; it does not synchronise.
template <int T>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, bool transpose) {
    constexpr int kVec = T * T / 4, kPer = (kVec + kThreads - 1) / kThreads;
    float4 x[kPer];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {      // every load in flight before the first store
        const int v = threadIdx.x + p * kThreads;
        if (v < kVec) x[p] = *reinterpret_cast<const float4*>(src + (v % T) * T + 4 * (v / T));
    }
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
        const int v = threadIdx.x + p * kThreads;
        if (v < kVec) Stage<T>::put(dst, x[p], v, transpose);
    }
}

// Solve one right-hand-side column of L x = b (BACK false, forward
// substitution) or L^T x = b (BACK true, backward substitution), the column
// in registers x.  S is the T x T tile in shared memory with row stride ld (a
// multiple of 4; S 16-byte aligned), laid out so that row j of S holds what
// x_j updates: S[j * ld + i] = L[i, j] (L transposed) forward, L[j, i] (L as
// it is) backward; only the lower triangle of L is read.  Right-looking: x_j
// is final once divided by its pivot and then updates every later entry,
// independent FMAs with the row of S read as float4 broadcasts.  Both loops
// unroll, so x stays in registers and the masks fold away.  The columns of
// a panel are independent, so a block gives each thread its own column.
// Does not synchronise.
template <int T, bool BACK>
__device__ __forceinline__ void substitute_panel(const float* S, int ld, float (&x)[T]) {
#pragma unroll
    for (int s = 0; s < T; ++s) {
        const int j = BACK ? T - 1 - s : s;
        x[j] = x[j] / S[j * ld + j];
#pragma unroll
        for (int q = 0; q < T / 4; ++q) {
            if (BACK ? 4 * q < j : 4 * q + 3 > j) {
                const float4 v = *reinterpret_cast<const float4*>(S + j * ld + 4 * q);
                const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int i = 4 * q + u;
                    if (BACK ? i < j : i > j) x[i] = fmaf(-w[u], x[j], x[i]);
                }
            }
        }
    }
}

// One column of a panel through substitute_panel, in a function of its
// own: x[i] = src[i * ss], solved, then dst[i * ds] = x[i].  A kernel that
// also holds tile-product accumulators calls this instead of inlining
// substitute_panel, so the T-float column is allocated apart from them:
// what the caller keeps live is saved around the call, once a column,
// instead of spilling inside the substitution or the products (inlined at
// T = 64 both kernels reached 255 registers and spilled 4 KB).
template <int T, bool BACK>
__device__ __noinline__ void solve_column(const float* S, int ld, const float* src, int ss,
                                          float* dst, size_t ds) {
    float x[T];
#pragma unroll
    for (int i = 0; i < T; ++i) x[i] = src[i * ss];
    substitute_panel<T, BACK>(S, ld, x);
#pragma unroll
    for (int i = 0; i < T; ++i) dst[i * ds] = x[i];
}

}  // namespace stiles

// The message of a CUDA error code, for the Python wrappers.
extern "C" const char* stiles_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
