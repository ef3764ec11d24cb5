// The whole backward Takahashi recurrence of a banded-arrowhead factor in
// one launch: the band + arrow block of Sigma = A^{-1}.
//
// Replaces the TPU kernel src/repro/kernels/selinv.py::selinv_sweep_pallas
// (body _selinv_sweep_kernel -> _selinv_sweep_body).  Inputs are the
// column view of the factor lcol (ndt, bt+1, T, T), lcol[j, d] = L[j+d, j]
// (zero past ndt), the arrow rows r (ndt, nat, T, T) and the full
// (symmetric) corner seed sc (nat, nat, T, T); outputs are the Sigma column
// panels (ndt, bt+1, T, T), panels[j, e] = Sigma[j+e, j], and the arrow
// entries acols (ndt, nat, T, T), acols[j, i] = Sigma[ndt+i, j].
//
// One block walks the columns j = ndt-1 .. 0.  Column j:
//   W = L_jj^{-1}                       substitute_panel against the identity
//   G_d = L[j+d, j] W, Ga_i = R[j, i] W the normalized factor column
//   off_e  = -(sum_d S(e, d) G_d + sum_i acols[j+e, i]^T Ga_i),  e = 1..bt
//            S(e, d) = panels[j+d, e-d] (e >= d) or panels[j+e, d-e]^T
//   acol_i = -(sum_i' sc[i, i'] Ga_i' + sum_d acols[j+d, i] G_d)
//   S_jj   = W^T W - sum_e off_e^T G_e - sum_i acol_i^T Ga_i, then 0.5 (S + S^T)
// Terms reaching past column ndt-1 are zero and skipped.  Columns j < start
// are an identity-embedding prefix: an identity panel and zero arrow row.
//
// The TPU kernel keeps the last bt Sigma columns in a VMEM ring; here they
// are the block's own outputs, read back from device memory (L2).  W, G and
// Ga go to a scratch buffer the wrapper allocates, so every tile product
// is gemm_sum over device-memory operands, each transposed or not.
//
// Bound on this card: operations.  An interior column needs (bt + nat)^2
// general tile products (2 T^3 each), bt + nat products by the triangular W
// and bt + nat summed into the symmetric S_jj (T^3 each), W^T W and W
// itself (T^3 / 3 each): 144.7 T^3 at bt = nat = 4, about 5.9 Gflop on
// Table II matrix 5 (ndt = 157, bt = 4, nat = 4, T = 64), 0.088 ms at the
// card's fp32 rate, against about 46 MB moved (14 us).  This first design is one block of 256 threads, so it is
// held to one SM of 132, and its products are those of the band-Cholesky
// sweep (float4-staged operands, a 4 x 4 accumulator block a thread).
#include "tile.cuh"

namespace stiles {

template <int T>
__global__ void __launch_bounds__(kThreads, 1)
selinv_sweep_kernel(const float* __restrict__ lcol, const float* __restrict__ r_in,
                    const float* __restrict__ sc, float* work, float* panels, float* acols,
                    int ndt, int bt, int nat, int start) {
    constexpr int LDK = Tile<T>::LDK;
    constexpr size_t TT = static_cast<size_t>(T) * T;
    __shared__ __align__(16) float As[T * LDK];
    __shared__ __align__(16) float Bs[T * LDK];
    const int b1 = bt + 1;
    // panels, acols and work are written and read back by this block: plain loads
    auto P = [&](int j, int e) { return panels + (static_cast<size_t>(j) * b1 + e) * TT; };
    auto AC = [&](int j, int i) { return acols + (static_cast<size_t>(j) * nat + i) * TT; };
    auto LC = [&](int j, int d) { return lcol + (static_cast<size_t>(j) * b1 + d) * TT; };
    auto RI = [&](int j, int i) { return r_in + (static_cast<size_t>(j) * nat + i) * TT; };
    auto SC = [&](int i, int q) { return sc + (static_cast<size_t>(i) * nat + q) * TT; };
    float* W = work;                                  // L_jj^{-1}
    auto G = [&](int d) { return work + static_cast<size_t>(d) * TT; };          // d = 1..bt
    auto GA = [&](int i) { return work + static_cast<size_t>(1 + bt + i) * TT; };

    auto store_neg = [&](float* dst, Acc<T>& acc) {
#pragma unroll
        for (int r = 0; r < Tile<T>::M; ++r)
#pragma unroll
            for (int s = 0; s < Tile<T>::M; ++s) acc[r][s] = -acc[r][s];
        store_tile<T>(dst, acc);
    };
    auto fill = [&](float* dst, int ntiles, bool identity) {
        for (size_t idx = threadIdx.x; idx < ntiles * TT; idx += kThreads)
            dst[idx] = (identity && idx < TT && idx / T == idx % T) ? 1.f : 0.f;
    };

    Acc<T> acc;
    for (int j = ndt - 1; j >= 0; --j) {
        if (j < start) {
            fill(P(j, 0), b1, true);
            fill(AC(j, 0), nat, false);
            continue;
        }
        const int dmax = min(bt, ndt - 1 - j);   // band rows below j inside the matrix

        // W = L_jj^{-1}: the identity, column c solved in place by thread c
        __syncthreads();  // As is free
        stage_tile<T>(As, LC(j, 0), true);        // S[c, i] = L_jj[i, c]
        fill(W, 1, true);
        __syncthreads();
        if (threadIdx.x < T)
            solve_column<T, false>(As, LDK, W + threadIdx.x, T, W + threadIdx.x, T);
        __syncthreads();  // W is written

        // normalized factor column
        const Op w_op{W, false};
        for (int d = 1; d <= dmax; ++d) {
            zero_acc<T>(acc);
            gemm_sum<T>(acc, 1, [&](int) { return Op{LC(j, d), false}; },
                        [&](int) { return w_op; }, As, Bs);
            store_tile<T>(G(d), acc);
        }
        for (int i = 0; i < nat; ++i) {
            zero_acc<T>(acc);
            gemm_sum<T>(acc, 1, [&](int) { return Op{RI(j, i), false}; },
                        [&](int) { return w_op; }, As, Bs);
            store_tile<T>(GA(i), acc);
        }
        __syncthreads();  // G and Ga are written

        // band targets Sigma[j+e, j]
        for (int e = 1; e <= bt; ++e) {
            if (e > dmax) {
                fill(P(j, e), 1, false);
                continue;
            }
            zero_acc<T>(acc);
            gemm_sum<T>(acc, dmax,
                        [&](int q) {
                            const int d = q + 1;
                            return e >= d ? Op{P(j + d, e - d), false} : Op{P(j + e, d - e), true};
                        },
                        [&](int q) { return Op{G(q + 1), false}; }, As, Bs);
            gemm_sum<T>(acc, nat, [&](int q) { return Op{AC(j + e, q), true}; },
                        [&](int q) { return Op{GA(q), false}; }, As, Bs);
            store_neg(P(j, e), acc);
        }
        // arrow targets Sigma[ndt+i, j]
        for (int i = 0; i < nat; ++i) {
            zero_acc<T>(acc);
            gemm_sum<T>(acc, nat, [&](int q) { return Op{SC(i, q), false}; },
                        [&](int q) { return Op{GA(q), false}; }, As, Bs);
            gemm_sum<T>(acc, dmax, [&](int q) { return Op{AC(j + q + 1, i), false}; },
                        [&](int q) { return Op{G(q + 1), false}; }, As, Bs);
            store_neg(AC(j, i), acc);
        }
        __syncthreads();  // this column's off-diagonal Sigma tiles are written

        // diagonal: W^T W - sum_e off_e^T G_e - sum_i acol_i^T Ga_i
        zero_acc<T>(acc);
        gemm_sum<T>(acc, dmax, [&](int q) { return Op{P(j, q + 1), true}; },
                    [&](int q) { return Op{G(q + 1), false}; }, As, Bs);
        gemm_sum<T>(acc, nat, [&](int q) { return Op{AC(j, q), true}; },
                    [&](int q) { return Op{GA(q), false}; }, As, Bs);
        Acc<T> s0;
        zero_acc<T>(s0);
        gemm_sum<T>(s0, 1, [&](int) { return Op{W, true}; }, [&](int) { return w_op; }, As, Bs);
        // symmetrize through shared memory: As[r * LDK + c] = S[r, c]
        __syncthreads();  // As is free
        if (owns_tile<T>()) {
#pragma unroll
            for (int r = 0; r < Tile<T>::M; ++r)
#pragma unroll
                for (int s = 0; s < Tile<T>::M; ++s)
                    As[owner_row<T>(r) * LDK + owner_col<T>(s)] = s0[r][s] - acc[r][s];
        }
        __syncthreads();
        if (owns_tile<T>()) {
#pragma unroll
            for (int r = 0; r < Tile<T>::M; ++r)
#pragma unroll
                for (int s = 0; s < Tile<T>::M; ++s) {
                    const int row = owner_row<T>(r), col = owner_col<T>(s);
                    acc[r][s] = 0.5f * (As[row * LDK + col] + As[col * LDK + row]);
                }
        }
        store_tile<T>(P(j, 0), acc);
        __syncthreads();  // column j is complete before column j - 1 reads it
    }
}

template <int T>
int launch_selinv(const float* lcol, const float* r, const float* sc, float* work,
                  float* panels, float* acols, int ndt, int bt, int nat, int start,
                  cudaStream_t s) {
    selinv_sweep_kernel<T><<<1, kThreads, 0, s>>>(lcol, r, sc, work, panels, acols, ndt, bt,
                                                  nat, start);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace stiles

// lcol (ndt, bt+1, t, t), r (ndt, nat, t, t), sc (nat, nat, t, t), work
// (1 + bt + nat, t, t) scratch -> panels (ndt, bt+1, t, t), acols
// (ndt, nat, t, t); ndt >= 1.
extern "C" int stiles_selinv_sweep_f32(const void* lcol, const void* r, const void* sc,
                                       void* work, void* panels, void* acols, int ndt, int bt,
                                       int nat, int t, int start, void* stream) {
    using namespace stiles;
    const auto* pl = static_cast<const float*>(lcol);
    const auto* pr = static_cast<const float*>(r);
    const auto* psc = static_cast<const float*>(sc);
    auto* pw = static_cast<float*>(work);
    auto* pp = static_cast<float*>(panels);
    auto* pa = static_cast<float*>(acols);
    auto s = static_cast<cudaStream_t>(stream);
    switch (t) {
        case 8: return launch_selinv<8>(pl, pr, psc, pw, pp, pa, ndt, bt, nat, start, s);
        case 16: return launch_selinv<16>(pl, pr, psc, pw, pp, pa, ndt, bt, nat, start, s);
        case 32: return launch_selinv<32>(pl, pr, psc, pw, pp, pa, ndt, bt, nat, start, s);
        case 64: return launch_selinv<64>(pl, pr, psc, pw, pp, pa, ndt, bt, nat, start, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
