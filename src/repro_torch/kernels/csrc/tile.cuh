// Device functions shared by the potrf, trsm and band-Cholesky kernels.
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

    // As[c * LDK + r] = A[r, c], likewise Bs
    __device__ __forceinline__ void store(float* As, float* Bs) const {
        constexpr int LDK = Tile<T>::LDK;
#pragma unroll
        for (int p = 0; p < kPer; ++p) {
            const int v = threadIdx.x + p * kThreads;
            if (v < kVec) {
                const int o = 4 * (v / T) * LDK + v % T;
                As[o] = a[p].x; As[o + LDK] = a[p].y; As[o + 2 * LDK] = a[p].z; As[o + 3 * LDK] = a[p].w;
                Bs[o] = b[p].x; Bs[o + LDK] = b[p].y; Bs[o + 2 * LDK] = b[p].z; Bs[o + 3 * LDK] = b[p].w;
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

// acc += sum_{q < n} A(q) B(q)^T for row-major T x T tiles in device memory
// (A and B map q to a tile address), staged through the shared buffers As
// and Bs (T * LDK floats each).  The next pair's loads are in flight while
// the current pair is multiplied.  n must be the same in every thread:
// every thread of the block calls it, and it synchronises the block twice
// per pair.
template <int T, typename FA, typename FB>
__device__ void gemm_nt_sum(Acc<T>& acc, int n, FA A, FB B, float* As, float* Bs) {
    if (n <= 0) return;
    Stage<T> st;
    st.load(A(0), B(0));
    for (int q = 0; q < n; ++q) {
        __syncthreads();  // the staging buffers are free
        st.store(As, Bs);
        __syncthreads();
        if (q + 1 < n) st.load(A(q + 1), B(q + 1));
        mma_staged<T>(acc, As, Bs);
    }
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

}  // namespace stiles

// The message of a CUDA error code, for the Python wrappers.
extern "C" const char* stiles_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
