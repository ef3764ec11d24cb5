// Device functions shared by the potrf, trsm, band-Cholesky, solve-panel,
// band-solve and selected-inversion kernels.
//
// Every kernel here runs kThreads threads per block over float32 T x T
// tiles, T in {8, 16, 32, 64}.  A tile held in registers is spread over the
// block in the "owner layout": thread (ty, tx) = (tid / NT, tid % NT) holds
// the M x M block of elements (ty*M + r, tx*M + s), r, s < M, so each
// thread reads and writes M contiguous floats of a row at once.  A tile
// product C += A B^T stages A and B in shared memory transposed
// (contraction index major), where every owner reads its M rows of A and M
// columns of B as one vector per contraction step.
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

// acc += sum_{q < n} A(q) B(q)^T for row-major T x T tiles in device memory
// (A and B map q to a tile address): gemm_sum with B transposed.
template <int T, typename FA, typename FB>
__device__ __forceinline__ void gemm_nt_sum(Acc<T>& acc, int n, FA A, FB B, float* As,
                                            float* Bs) {
    gemm_sum<T>(acc, n, [&](int q) { return Op{A(q), false}; },
                [&](int q) { return Op{B(q), true}; }, As, Bs);
}

// Owner-layout tile from a row-major T x T tile, minus acc.
template <int T>
__device__ __forceinline__ void load_minus(Acc<T>& out, const float* src, const Acc<T>& acc) {
    constexpr int M = Tile<T>::M;
#pragma unroll
    for (int r = 0; r < M; ++r) {
        float v[M];
        if (owns_tile<T>()) {
            ld_vec<M>(v, src + owner_row<T>(r) * T + owner_col<T>(0));
        } else {
#pragma unroll
            for (int s = 0; s < M; ++s) v[s] = acc[r][s];
        }
#pragma unroll
        for (int s = 0; s < M; ++s) out[r][s] = v[s] - acc[r][s];
    }
}

// dst = src - acc, row-major T x T tiles.
template <int T>
__device__ __forceinline__ void store_minus(float* dst, const float* src, const Acc<T>& acc) {
    constexpr int M = Tile<T>::M;
    if (!owns_tile<T>()) return;
#pragma unroll
    for (int r = 0; r < M; ++r) {
        const int o = owner_row<T>(r) * T + owner_col<T>(0);
        float v[M];
        ld_vec<M>(v, src + o);
#pragma unroll
        for (int s = 0; s < M; ++s) v[s] -= acc[r][s];
        st_vec<M>(dst + o, v);
    }
}

// dst += acc, or dst^T += acc, row-major T x T tile.
template <int T>
__device__ __forceinline__ void store_add(float* dst, const Acc<T>& acc, bool transposed) {
    constexpr int M = Tile<T>::M;
    if (!owns_tile<T>()) return;
    if (!transposed) {
#pragma unroll
        for (int r = 0; r < M; ++r) {
            const int o = owner_row<T>(r) * T + owner_col<T>(0);
            float v[M];
            ld_vec<M>(v, dst + o);
#pragma unroll
            for (int s = 0; s < M; ++s) v[s] += acc[r][s];
            st_vec<M>(dst + o, v);
        }
    } else {
#pragma unroll
        for (int s = 0; s < M; ++s) {
            const int o = owner_col<T>(s) * T + owner_row<T>(0);
            float v[M];
            ld_vec<M>(v, dst + o);
#pragma unroll
            for (int r = 0; r < M; ++r) v[r] += acc[r][s];
            st_vec<M>(dst + o, v);
        }
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

template <int T>
__device__ __forceinline__ bool any_nonfinite(const Acc<T>& a) {
    bool bad = false;
#pragma unroll
    for (int r = 0; r < Tile<T>::M; ++r)
#pragma unroll
        for (int s = 0; s < Tile<T>::M; ++s) bad |= !isfinite(a[r][s]);
    return bad;
}

// Cholesky of the owner-layout tile `a` in place: a right-looking column
// loop that reads the lower triangle and leaves L with zeros above the
// diagonal.  A non-positive pivot gives NaN (1/sqrt of a negative number),
// which then fills the rest of the tile, as the TPU kernel's rsqrt does.
// colv is T + 1 floats of shared memory.  Every thread of the block must
// call it: it synchronises the block twice per column.
template <int T>
__device__ void factorize_tile(Acc<T>& a, float* colv) {
    constexpr int NT = Tile<T>::NT, M = Tile<T>::M;
    const bool own = owns_tile<T>();
    const int ty = threadIdx.x / NT, tx = threadIdx.x % NT;
    // element updates are selects, not branches: divergent branches around
    // register updates cost a warp reconvergence each
    for (int j = 0; j < T; ++j) {
        const int jb = j / M, jr = j % M;  // owner block and slot of row/column j
        // the owner of (j, j) publishes the pivot
        float pv = a[0][0];
#pragma unroll
        for (int r = 1; r < M; ++r) pv = jr == r ? a[r][r] : pv;
        if (own && ty == jb && tx == jb) colv[T] = pv;
        __syncthreads();
        const float dinv = 1.f / sqrtf(colv[T]);
        // the owners of column j publish it scaled, zero above the diagonal
        if (own && tx == jb) {
#pragma unroll
            for (int r = 0; r < M; ++r) {
                float v = a[r][0];
#pragma unroll
                for (int s = 1; s < M; ++s) v = jr == s ? a[r][s] : v;
                const int i = owner_row<T>(r);
                colv[i] = i >= j ? v * dinv : 0.f;
            }
        }
        __syncthreads();
        // write column j and update the trailing block
        if (own) {
            float ci[M], cm[M];
#pragma unroll
            for (int r = 0; r < M; ++r) ci[r] = colv[owner_row<T>(r)];
#pragma unroll
            for (int s = 0; s < M; ++s) cm[s] = colv[owner_col<T>(s)];
#pragma unroll
            for (int r = 0; r < M; ++r)
#pragma unroll
                for (int s = 0; s < M; ++s) {
                    const int i = owner_row<T>(r), m = owner_col<T>(s);
                    const float upd = fmaf(-ci[r], cm[s], a[r][s]);
                    a[r][s] = m == j ? ci[r] : (i > j && m > j ? upd : a[r][s]);
                }
        }
    }
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
        for (int s = 0; s < M; ++s)
            if (owner_col<T>(s) > owner_row<T>(r)) a[r][s] = 0.f;
}

// Store the owner-layout L transposed (Lt[m * T + i] = L[i, m]) and the
// reciprocals of its diagonal, the operands of substitute_right_rows.
template <int T>
__device__ __forceinline__ void store_substitution_operands(float* Lt, float* dinv,
                                                            const Acc<T>& l) {
    if (!owns_tile<T>()) return;
#pragma unroll
    for (int r = 0; r < Tile<T>::M; ++r)
#pragma unroll
        for (int s = 0; s < Tile<T>::M; ++s) {
            const int i = owner_row<T>(r), m = owner_col<T>(s);
            Lt[m * T + i] = l[r][s];
            if (i == m) dinv[i] = 1.f / l[r][s];
        }
}

// Solve X L^T = A for nrows independent rows: row r is read from src(r)
// and written to dst(r) (T floats each; they may alias).  Each warp solves
// kSubRows rows together, its lanes owning the columns c = lane + 32 q; a
// right-looking column loop (x_j = a_j / L[j, j], then a_c -= x_j L[c, j]
// for c > j) broadcasts x_j by shuffle and reads row j of Lt, so
// neighbouring lanes read neighbouring words.  Every thread of the block
// must call it; it does not synchronise.  Returns true if this thread's
// share of the solution is not finite.
constexpr int kSubRows = 8;

template <int T, typename Src, typename Dst>
__device__ bool substitute_right_rows(const float* Lt, const float* dinv, int nrows,
                                      Src src, Dst dst) {
    constexpr int Q = (T + 31) / 32;     // column blocks of 32
    constexpr int W = T < 32 ? T : 32;   // columns in a block
    constexpr int kWarps = kThreads / 32;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    bool bad = false;
    for (int r0 = warp * kSubRows; r0 < nrows; r0 += kWarps * kSubRows) {
        float x[kSubRows][Q];
#pragma unroll
        for (int r = 0; r < kSubRows; ++r)
#pragma unroll
            for (int q = 0; q < Q; ++q) {
                const int c = lane + 32 * q;
                x[r][q] = (r0 + r < nrows && c < T) ? src(r0 + r)[c] : 0.f;
            }
#pragma unroll
        for (int qj = 0; qj < Q; ++qj) {
#pragma unroll 2
            for (int jj = 0; jj < W; ++jj) {
                const int j = 32 * qj + jj;
                const float dj = dinv[j];
                float lt[Q];
#pragma unroll
                for (int q = qj; q < Q; ++q) {
                    const int c = lane + 32 * q;
                    lt[q] = c < T ? Lt[j * T + c] : 0.f;
                }
                // selects, not branches (see factorize_tile)
                const bool is_j = lane == jj, after = lane > jj;
#pragma unroll
                for (int r = 0; r < kSubRows; ++r) {
                    const float xj = __shfl_sync(0xffffffffu, x[r][qj], jj) * dj;
                    const float upd = fmaf(-xj, lt[qj], x[r][qj]);
                    x[r][qj] = is_j ? xj : (after ? upd : x[r][qj]);
#pragma unroll
                    for (int q = qj + 1; q < Q; ++q) x[r][q] = fmaf(-xj, lt[q], x[r][q]);
                }
            }
        }
#pragma unroll
        for (int r = 0; r < kSubRows; ++r)
#pragma unroll
            for (int q = 0; q < Q; ++q) {
                const int c = lane + 32 * q;
                if (r0 + r < nrows && c < T) {
                    dst(r0 + r)[c] = x[r][q];
                    bad |= !isfinite(x[r][q]);
                }
            }
    }
    return bad;
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
