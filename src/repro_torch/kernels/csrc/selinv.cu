// The whole backward Takahashi recurrence of a banded-arrowhead factor: the
// band + arrow block of Sigma = A^{-1}, in two launches.
//
// Replaces the TPU kernel src/repro/kernels/selinv.py::selinv_sweep_pallas
// (body _selinv_sweep_kernel -> _selinv_sweep_body).  Inputs are the
// column view of the factor lcol (ndt, bt+1, T, T), lcol[j, d] = L[j+d, j]
// (zero past ndt), the arrow rows r (ndt, nat, T, T) and the full
// (symmetric) corner seed sc (nat, nat, T, T); outputs are the Sigma column
// panels (ndt, bt+1, T, T), panels[j, e] = Sigma[j+e, j], and the arrow
// entries acols (ndt, nat, T, T), acols[j, i] = Sigma[ndt+i, j].
//
// Column j of the recurrence (walked j = ndt-1 .. 0):
//   W = L_jj^{-1},  G_d = L[j+d, j] W,  Ga_i = R[j, i] W
//   off_e  = -(sum_d S(e, d) G_d + sum_i acols[j+e, i]^T Ga_i),  e = 1..bt
//            S(e, d) = panels[j+d, e-d] (e >= d) or panels[j+e, d-e]^T
//   acol_i = -(sum_i' sc[i, i'] Ga_i' + sum_d acols[j+d, i] G_d)
//   S_jj   = W^T W - sum_e off_e^T G_e - sum_i acol_i^T Ga_i, then 0.5 (S + S^T)
// Terms reaching past column ndt-1 are zero and skipped.  Columns j < start
// are an identity-embedding prefix: an identity panel and zero arrow row,
// which the recurrence writes without computing (no later column reads a
// prefix column, so its walk stops at start).
//
// A batch of such factors, each element's inputs and outputs contiguous after
// the one before, is the same two launches with blockIdx.y the element: the
// pre-pass a block for each column of each element, the recurrence a cluster
// for each element on the same plan.  The element's pointer offsets are the
// only change, so element i is written bit for bit as its unbatched launch
// writes it.
//
// Much of a column depends on the factor and the corner seed alone: W, G,
// Ga, W^T W and the corner part sum_i' sc[i, i'] Ga_i'.  The pre-pass
// (selinv_prepass_kernel) computes them for every column at once, a block of
// 256 threads a column over the whole card, into a work buffer of
// bt + 2 nat + 2 tiles a column (G, Ga, corner parts, W^T W, W); a prefix
// column gets W = W^T W = I and zeros, which the recurrence turns into the
// identity panel.  What is left is a chain across columns through Sigma
// only, and within a column the bt + nat targets are independent given G.
// The recurrence (selinv_recurrence_kernel) is one thread-block cluster of
// CL blocks of 128 threads on the plan of kernels/selinv.py::selinv_plan:
//   - targets: every target tile is split into S x S sub-tiles (S =
//     min(T, 32)); rank r computes sub-tiles r, r + CL, ... whole, each
//     over its pairs in order, and stores it;
//   - cluster.sync();
//   - diagonal: its lower sub-tiles only (an upper one is the transpose of
//     a lower one), sub-tile s on ranks s*K .. s*K+K-1 (K = diag_split),
//     each summing a contiguous run of the pairs; then, when K > 1, a
//     cluster.sync() and the first of them adds the others' partials in
//     rank order through distributed shared memory, subtracts the sum from
//     W^T W and stores the sub-tile, symmetrized within the block on the
//     diagonal, and with its transpose above the diagonal otherwise;
//   - cluster.sync() before the next column reads this one.
// Sigma's tiles are the outputs, in device memory: each rank writes them
// with plain stores and reads them with cp.async.cg (through L2, not the
// SM's L1), and the cluster barrier's release (arrive) and acquire (wait)
// at cluster scope is what makes one block's stores visible to the next
// phase's readers in the other blocks.  Every sum's order is fixed by the
// plan, not by block timing, so two launches give the same bits.  A tile
// product is plain fp32 FMA (no TF32): operands staged by cp.async into a
// double buffer, an A operand either as it is (S rows of k) or transposed
// (k rows of S), B as it is.
//
// Bound on this card: operations.  An interior column needs (bt + nat)^2
// general tile products (2 T^3 each), bt + nat products by the triangular W
// and bt + nat summed into the symmetric S_jj (T^3 each), W^T W and W
// itself (T^3 / 3 each): 144.7 T^3 at bt = nat = 4, about 5.9 Gflop on
// Table II matrix 5 (ndt = 157, bt = 4, nat = 4, T = 64), 0.088 ms at the
// card's fp32 rate, against about 46 MB moved (14 us).  The first design
// ran the whole recurrence on one block; here the recurrence's chain runs
// on CL SMs (16: the most the card allows a cluster) and the pre-pass on
// all of them.
#include "tile_sum.cuh"

namespace stiles {

// ---------------------------------------------------------------------------
// pre-pass: a block a column
// ---------------------------------------------------------------------------

template <int T>
__global__ void __launch_bounds__(kThreads)
selinv_prepass_kernel(const float* __restrict__ lcol, const float* __restrict__ r_in,
                      const float* __restrict__ sc, float* work, int ndt, int bt, int nat,
                      int start) {
    constexpr int LDK = Tile<T>::LDK;
    constexpr size_t TT = static_cast<size_t>(T) * T;
    __shared__ __align__(16) float As[T * LDK];
    __shared__ __align__(16) float Bs[T * LDK];
    const int j = blockIdx.x, b1 = bt + 1, nq = bt + nat, nw = bt + 2 * nat + 2;
    {   // this block's batch element
        const size_t el = blockIdx.y;
        lcol += el * ndt * b1 * TT;
        r_in += el * ndt * nat * TT;
        sc += el * nat * nat * TT;
        work += el * ndt * nw * TT;
    }
    auto LC = [&](int d) { return lcol + (static_cast<size_t>(j) * b1 + d) * TT; };
    auto RI = [&](int i) { return r_in + (static_cast<size_t>(j) * nat + i) * TT; };
    auto SC = [&](int i, int q) { return sc + (static_cast<size_t>(i) * nat + q) * TT; };
    // this column's work tiles: G_1..G_bt, Ga, corner parts, W^T W, W
    auto WK = [&](int q) { return work + (static_cast<size_t>(j) * nw + q) * TT; };
    float* S0 = WK(nq + nat);
    float* W = WK(nq + nat + 1);
    auto fill = [&](float* dst, int ntiles, bool identity) {
        for (size_t idx = threadIdx.x; idx < ntiles * TT; idx += kThreads)
            dst[idx] = (identity && idx < TT && idx / T == idx % T) ? 1.f : 0.f;
    };
    if (j < start) {
        fill(WK(0), nq + nat, false);
        fill(S0, 1, true);
        fill(W, 1, true);
        return;
    }
    const int dmax = min(bt, ndt - 1 - j);   // band rows below j inside the matrix

    // W = L_jj^{-1}: the identity, column c solved in place by thread c
    stage_tile<T>(As, LC(0), true);          // S[c, i] = L_jj[i, c]
    fill(W, 1, true);
    __syncthreads();
    if (threadIdx.x < T)
        solve_column<T, false>(As, LDK, W + threadIdx.x, T, W + threadIdx.x, T);
    __syncthreads();  // W is written

    const Op w_op{W, false};
    Acc<T> acc;
    for (int d = 1; d <= bt; ++d) {
        if (d > dmax) {
            fill(WK(d - 1), 1, false);
            continue;
        }
        zero_acc<T>(acc);
        gemm_sum<T>(acc, 1, [&](int) { return Op{LC(d), false}; }, [&](int) { return w_op; },
                    As, Bs);
        store_tile<T>(WK(d - 1), acc);
    }
    for (int i = 0; i < nat; ++i) {
        zero_acc<T>(acc);
        gemm_sum<T>(acc, 1, [&](int) { return Op{RI(i), false}; }, [&](int) { return w_op; },
                    As, Bs);
        store_tile<T>(WK(bt + i), acc);
    }
    zero_acc<T>(acc);
    gemm_sum<T>(acc, 1, [&](int) { return Op{W, true}; }, [&](int) { return w_op; }, As, Bs);
    store_tile<T>(S0, acc);
    __syncthreads();  // Ga is written
    // the corner part of each arrow target: sum_i' sc[i, i'] Ga_i'
    for (int i = 0; i < nat; ++i) {
        zero_acc<T>(acc);
        gemm_sum<T>(acc, nat, [&](int q) { return Op{SC(i, q), false}; },
                    [&](int q) { return Op{WK(bt + q), false}; }, As, Bs);
        store_tile<T>(WK(nq + i), acc);
    }
}

// ---------------------------------------------------------------------------
// recurrence: one cluster
// ---------------------------------------------------------------------------

template <int T>
struct RecShape {
    using Sh = SumShape<T>;
    static constexpr int S = Sh::S, NS = Sh::NS, LDK = Sh::LDK, LDN = Sh::LDN;
    static constexpr int MR = Sh::MR, MC = Sh::MC;
    // a stage of A: S rows of T (as it is) or T rows of S (transposed)
    static constexpr int A_SZ = S * LDK > T * LDN ? S * LDK : T * LDN;
    static constexpr int B_SZ = T * LDN;
    static constexpr int DIAG = NS * (NS + 1) / 2;   // lower sub-tiles of a tile
};

// One pair of a sum: op(A) B, op(A) = A^T where ta.
struct Pair {
    const float* a;
    const float* b;
    bool ta;
};

// acc += A^T B over the staged operands: As holds A's rows k (S columns of
// it a row), Bs B's rows k.
template <int T>
__device__ __forceinline__ void mma_at(float (&acc)[RecShape<T>::MR][RecShape<T>::MC],
                                       const float* As, const float* Bs, int ty, int tx) {
    using R = RecShape<T>;
    constexpr int MR = R::MR, MC = R::MC, LDN = R::LDN, NTY = SumShape<T>::NTY;
#pragma unroll 4
    for (int k0 = 0; k0 < T; k0 += 4) {
        float a[MR][4], b[4][MC];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int i = 0; i < MR; ++i) a[i][kk] = As[(k0 + kk) * LDN + ty + NTY * i];
            ld_vec<MC>(b[kk], Bs + (k0 + kk) * LDN + tx * MC);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < MR; ++i)
#pragma unroll
                for (int jj = 0; jj < MC; ++jj) acc[i][jj] = fmaf(a[i][kk], b[kk][jj], acc[i][jj]);
    }
}

// acc += sum_{p < n} op(A(p)) B(p) over the sub-tile at (r0, c0), pairs in
// order, the next pair's copies in flight while one is multiplied.  Every
// thread of the block calls it with the same n; it leaves the buffers free.
template <int T, typename F>
__device__ void pair_sum(float (&acc)[RecShape<T>::MR][RecShape<T>::MC], int n, F pair,
                         int r0, int c0, float* As, float* Bs, bool active, int ty, int tx) {
    using R = RecShape<T>;
    constexpr int S = R::S, LDK = R::LDK, LDN = R::LDN, A_SZ = R::A_SZ, B_SZ = R::B_SZ;
    auto stage = [&](int p, int buf) {
        const Pair o = pair(p);
        if (o.ta) {
            stage_rows<T, S, LDN, T>(As + buf * A_SZ, o.a + r0);
        } else {
            stage_rows<S, T, LDK, T>(As + buf * A_SZ, o.a + static_cast<size_t>(r0) * T);
        }
        stage_rows<T, S, LDN, T>(Bs + buf * B_SZ, o.b + c0);
        cp_async_commit();
    };
    if (n > 0) stage(0, 0);
    if (n > 1) stage(1, 1);
    for (int p = 0; p < n; ++p) {
        if (p + 1 < n) {
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();  // every thread's copies of pair p have landed
        if (active) {
            const float* as = As + (p & 1) * A_SZ;
            const float* bs = Bs + (p & 1) * B_SZ;
            if (pair(p).ta) {
                mma_at<T>(acc, as, bs, ty, tx);
            } else {
                mma_sub<T, false>(acc, as, bs, ty, tx);
            }
        }
        if (p + 2 < n) {
            __syncthreads();  // buffer p & 1 is free again
            stage(p + 2, p & 1);
        }
    }
    __syncthreads();
}

// Sigma of the identity prefix's columns j < start: an identity panel and a
// zero arrow row, thread `first` of `stride` writing every stride-th value.
// Out of line, so that it leaves the recurrence's registers alone.
template <int T>
__device__ __noinline__ void fill_prefix(float* panels, float* acols, int b1, int nat, int start,
                                         int first, int stride) {
    constexpr int TT = T * T;
    const int n_pan = start * b1 * TT, n_all = n_pan + start * nat * TT;
    for (int idx = first; idx < n_all; idx += stride) {
        if (idx < n_pan) {
            const int in = idx % (b1 * TT);
            panels[idx] = (in < TT && in / T == in % T) ? 1.f : 0.f;
        } else {
            acols[idx - n_pan] = 0.f;
        }
    }
}

template <int T>
__global__ void __launch_bounds__(kSumThreads)
selinv_recurrence_kernel(const float* __restrict__ work, float* panels, float* acols, int ndt,
                         int bt, int nat, int split, int start) {
    using R = RecShape<T>;
    constexpr int S = R::S, NS = R::NS, MR = R::MR, MC = R::MC, NTY = SumShape<T>::NTY;
    constexpr size_t TT = static_cast<size_t>(T) * T;
    __shared__ __align__(16) float As[2 * R::A_SZ];
    __shared__ __align__(16) float Bs[2 * R::B_SZ];
    __shared__ __align__(16) float part[kSumThreads * MR * MC];
    __shared__ float sym[S * (S + 1)];
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    const int cl = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int b1 = bt + 1, nq = bt + nat, nw = bt + 2 * nat + 2;
    {   // this cluster's batch element
        const size_t el = blockIdx.y;
        work += el * ndt * nw * TT;
        panels += el * ndt * b1 * TT;
        acols += el * ndt * nat * TT;
    }
    // panels and acols are written and read back by the cluster: no
    // __restrict__, no read-only loads
    auto P = [&](int j, int e) { return panels + (static_cast<size_t>(j) * b1 + e) * TT; };
    auto AC = [&](int j, int i) { return acols + (static_cast<size_t>(j) * nat + i) * TT; };
    auto WK = [&](int j, int q) { return work + (static_cast<size_t>(j) * nw + q) * TT; };
    const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
    const bool active = threadIdx.x < SumShape<T>::ACTIVE;
    const int units = nq * NS * NS;
    // this rank's share of the diagonal: lower sub-tile ds (row-major), run dk
    const int ds = rank / split, dk = rank % split;
    const bool in_diag = ds < R::DIAG;
    int drow = 0;
    while ((drow + 1) * (drow + 2) / 2 <= ds) ++drow;
    const int dr0 = drow * S, dc0 = (ds - drow * (drow + 1) / 2) * S;
    float* slot = part + threadIdx.x * MR * MC;

    for (int j = ndt - 1; j >= start; --j) {
        const int dmax = min(bt, ndt - 1 - j);   // band tiles below column j
        // the targets: band tiles e = 1..bt, then the arrow tiles
        for (int u = rank; u < units; u += cl) {
            const int k = u / (NS * NS), sub = u % (NS * NS);
            const int r0 = sub / NS * S, c0 = sub % NS * S;
            float acc[MR][MC];
#pragma unroll
            for (int i = 0; i < MR; ++i)
#pragma unroll
                for (int jj = 0; jj < MC; ++jj) acc[i][jj] = 0.f;
            float* dst;
            const float* init = nullptr;
            if (k < bt) {
                const int e = k + 1;
                dst = P(j, e);
                if (e <= dmax) {
                    pair_sum<T>(acc, dmax + nat, [&](int p) {
                        if (p < dmax) {
                            const int d = p + 1;
                            return e >= d ? Pair{P(j + d, e - d), WK(j, p), false}
                                          : Pair{P(j + e, d - e), WK(j, p), true};
                        }
                        return Pair{AC(j + e, p - dmax), WK(j, bt + p - dmax), true};
                    }, r0, c0, As, Bs, active, ty, tx);
                }
            } else {
                const int i = k - bt;
                dst = AC(j, i);
                init = WK(j, nq + i);     // the corner part, from the pre-pass
                pair_sum<T>(acc, dmax, [&](int p) {
                    return Pair{AC(j + p + 1, i), WK(j, p), false};
                }, r0, c0, As, Bs, active, ty, tx);
            }
            if (active) {
#pragma unroll
                for (int i = 0; i < MR; ++i) {
                    const size_t o = static_cast<size_t>(r0 + ty + NTY * i) * T + c0 + tx * MC;
                    float v[MC];
                    if (init) {
                        ld_vec<MC>(v, init + o);
                    } else {
#pragma unroll
                        for (int jj = 0; jj < MC; ++jj) v[jj] = 0.f;
                    }
#pragma unroll
                    for (int jj = 0; jj < MC; ++jj) v[jj] = -(v[jj] + acc[i][jj]);
                    st_vec<MC>(dst + o, v);
                }
            }
        }
        cluster.sync();   // this column's targets are visible to every rank

        // the diagonal: sum_e off_e^T G_e + sum_i acol_i^T Ga_i, lower sub-tiles
        float acc[MR][MC];
#pragma unroll
        for (int i = 0; i < MR; ++i)
#pragma unroll
            for (int jj = 0; jj < MC; ++jj) acc[i][jj] = 0.f;
        if (in_diag) {
            const int n = dmax + nat, per = (n + split - 1) / split;
            const int lo = min(dk * per, n), len = min(lo + per, n) - lo;
            pair_sum<T>(acc, len, [&](int p) {
                const int q = lo + p;
                return q < dmax ? Pair{P(j, q + 1), WK(j, q), true}
                                : Pair{AC(j, q - dmax), WK(j, bt + q - dmax), true};
            }, dr0, dc0, As, Bs, active, ty, tx);
            if (dk > 0 && active) {
#pragma unroll
                for (int i = 0; i < MR; ++i) st_vec<MC>(slot + i * MC, acc[i]);
            }
        }
        if (split > 1) cluster.sync();   // the partials are in shared memory
        if (in_diag && dk == 0) {
            if (active) {
                for (int q = 1; q < split; ++q) {
                    const float* rs = cluster.map_shared_rank(slot, rank + q);
#pragma unroll
                    for (int i = 0; i < MR; ++i) {
                        float v[MC];
                        ld_vec<MC>(v, rs + i * MC);
#pragma unroll
                        for (int jj = 0; jj < MC; ++jj) acc[i][jj] += v[jj];
                    }
                }
            }
            const float* s0 = WK(j, nq + nat);
            float* pd = P(j, 0);
#pragma unroll
            for (int i = 0; i < MR; ++i) {
                const int row = ty + NTY * i;
                float v[MC];
                if (active) {
                    ld_vec<MC>(v, s0 + static_cast<size_t>(dr0 + row) * T + dc0 + tx * MC);
#pragma unroll
                    for (int jj = 0; jj < MC; ++jj) acc[i][jj] = v[jj] - acc[i][jj];
                }
            }
            if (dr0 == dc0) {
                // a diagonal sub-tile: 0.5 (S + S^T) within the block
                if (active) {
#pragma unroll
                    for (int i = 0; i < MR; ++i)
#pragma unroll
                        for (int jj = 0; jj < MC; ++jj)
                            sym[(ty + NTY * i) * (S + 1) + tx * MC + jj] = acc[i][jj];
                }
                __syncthreads();
                if (active) {
#pragma unroll
                    for (int i = 0; i < MR; ++i) {
                        const int row = ty + NTY * i;
                        float v[MC];
#pragma unroll
                        for (int jj = 0; jj < MC; ++jj) {
                            const int col = tx * MC + jj;
                            v[jj] = 0.5f * (sym[row * (S + 1) + col] + sym[col * (S + 1) + row]);
                        }
                        st_vec<MC>(pd + static_cast<size_t>(dr0 + row) * T + dc0 + tx * MC, v);
                    }
                }
            } else if (active) {
                // below the diagonal, and its transpose above it
#pragma unroll
                for (int i = 0; i < MR; ++i) {
                    const int row = dr0 + ty + NTY * i;
                    st_vec<MC>(pd + static_cast<size_t>(row) * T + dc0 + tx * MC, acc[i]);
#pragma unroll
                    for (int jj = 0; jj < MC; ++jj)
                        pd[static_cast<size_t>(dc0 + tx * MC + jj) * T + row] = acc[i][jj];
                }
            }
        }
        cluster.sync();   // column j is complete before column j - 1 reads it
    }
    // no column reads a prefix column: their Sigma is written last
    fill_prefix<T>(panels, acols, b1, nat, start, rank * kSumThreads + threadIdx.x,
                   cl * kSumThreads);
}

template <int T>
cudaError_t launch_prepass(const float* lcol, const float* r, const float* sc, float* work,
                           int batch, int ndt, int bt, int nat, int start, cudaStream_t s) {
    selinv_prepass_kernel<T><<<dim3(ndt, batch), kThreads, 0, s>>>(lcol, r, sc, work, ndt, bt,
                                                                    nat, start);
    return cudaGetLastError();
}

template <int T>
cudaError_t launch_recurrence(const float* work, float* panels, float* acols, int batch,
                              int ndt, int bt, int nat, int cl, int split, int start,
                              cudaStream_t s) {
    if (cl > kMaxCluster) {
        const cudaError_t err = cudaFuncSetAttribute(
            selinv_recurrence_kernel<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return err;
    }
    return launch_cluster(selinv_recurrence_kernel<T>, dim3(cl, batch), cl, 0, s, work, panels,
                          acols, ndt, bt, nat, split, start);
}

}  // namespace stiles

// lcol (ndt, bt+1, t, t), r (ndt, nat, t, t), sc (nat, nat, t, t) -> work
// (ndt, bt + 2 nat + 2, t, t); ndt >= 1; for each of `batch` such factors,
// contiguous one after another, in the same launch.
extern "C" int stiles_selinv_prepass_f32(const void* lcol, const void* r, const void* sc,
                                         void* work, int batch, int ndt, int bt, int nat, int t,
                                         int start, void* stream) {
    using namespace stiles;
    if (batch < 1 || batch > 65535 || ndt < 1 || bt < 0 || nat < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto* pl = static_cast<const float*>(lcol);
    const auto* pr = static_cast<const float*>(r);
    const auto* psc = static_cast<const float*>(sc);
    auto* pw = static_cast<float*>(work);
    auto s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (t) {
        case 8: err = launch_prepass<8>(pl, pr, psc, pw, batch, ndt, bt, nat, start, s); break;
        case 16: err = launch_prepass<16>(pl, pr, psc, pw, batch, ndt, bt, nat, start, s); break;
        case 32: err = launch_prepass<32>(pl, pr, psc, pw, batch, ndt, bt, nat, start, s); break;
        case 64: err = launch_prepass<64>(pl, pr, psc, pw, batch, ndt, bt, nat, start, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(err);
}

// work (ndt, bt + 2 nat + 2, t, t) from the pre-pass -> panels (ndt, bt+1,
// t, t), acols (ndt, nat, t, t), one cluster of `cluster` blocks on the
// plan of kernels/selinv.py::selinv_plan, checked here again: at most
// kMaxClusterNonPortable blocks, at least one a lower sub-tile of the diagonal
// and otherwise no more than the column's target sub-tiles, the diagonal
// split cluster / (lower sub-tiles) ways; a cluster for each of `batch`
// factors, contiguous one after another, in the same launch.  Columns
// j < start (start >= 0) are the identity prefix.
extern "C" int stiles_selinv_sweep_f32(const void* work, void* panels, void* acols, int batch,
                                       int ndt, int bt, int nat, int t, int cluster, int split,
                                       int start, void* stream) {
    using namespace stiles;
    const int ns = t < 32 ? 1 : t / 32, diag = ns * (ns + 1) / 2;
    const int units = (bt + nat) * ns * ns;
    if (batch < 1 || batch > 65535 || ndt < 1 || bt < 0 || nat < 0 || cluster < diag ||
        cluster > kMaxClusterNonPortable ||
        cluster > (units > diag ? units : diag) || split != cluster / diag || start < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (start > ndt) start = ndt;   // every column a prefix column
    const auto* pw = static_cast<const float*>(work);
    auto* pp = static_cast<float*>(panels);
    auto* pa = static_cast<float*>(acols);
    auto s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (t) {
        case 8: err = launch_recurrence<8>(pw, pp, pa, batch, ndt, bt, nat, cluster, split, start, s); break;
        case 16: err = launch_recurrence<16>(pw, pp, pa, batch, ndt, bt, nat, cluster, split, start, s); break;
        case 32: err = launch_recurrence<32>(pw, pp, pa, batch, ndt, bt, nat, cluster, split, start, s); break;
        case 64: err = launch_recurrence<64>(pw, pp, pa, batch, ndt, bt, nat, cluster, split, start, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
