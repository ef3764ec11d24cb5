// The whole banded-arrowhead Cholesky factorization in one launch, and its
// partition-parallel form.
//
// Replaces the TPU kernels
// src/repro/kernels/band_cholesky.py::band_cholesky_sweep_pallas (body
// _band_cholesky_kernel) and band_cholesky_partitioned_sweep_pallas (body
// _band_cholesky_partitioned_kernel).  Inputs are the column-band tiles
// ac (ndt, bt+1, T, T), ac[k, e] = A[k+e, k], and the arrow rows
// r (ndt, nat, T, T); outputs are the column panels of L, the factored
// arrow rows, the per-chunk corner-Schur sums schur (nch, nat, nat, T, T)
// and the status word [min_pivot, nonfinite, first_bad].
//
// One block walks the columns k = 0..ndt-1 in order.  Column k:
//   U[e] = sum_j L[k+e, k-j] L[k, k-j]^T   (e = 0..bt, j = 1..bt-e)
//   V[i] = sum_j L[ndt+i, k-j] L[k, k-j]^T (j = 1..bt)
//   L_kk = chol(A_kk - U[0]), in registers
//   the bt band tiles and nat arrow rows below it: (input - update) L_kk^{-T},
//   one batched right-substitution, kSubRows (8) rows to a warp
//   schur[k / csz] += L_a L_a^T, the chunk's partial sum
//   the status fold of the TPU kernel, from the emitted column
// Columns k < start are an identity-embedding prefix: they emit an identity
// panel and a zero arrow row and do no arithmetic.
//
// The partitioned sweep is the same kernel on P blocks.  Block p walks the
// columns [bounds[p], bounds[p+1]) of a block-separable band (no band tile
// crosses a cut), with its own Schur leaf schur[p] and its own status word;
// the host folds the P words.  A block never reads across its cut: a
// column's update stops at the partition's first column, where the fused
// sweep would go on to products with L[k, k-j] = 0 (the zero tiles across
// the cut).  Those products add exact zeros, so on a block-separable input
// the panels, arrow rows and status are bit-identical to the fused sweep's,
// and no block reads a panel that a neighbouring block may be writing.  The
// fused sweep is the one-block case, bounds = {0, ndt}; its Schur chunks are
// csz columns long, the partitioned sweep's one partition long.  The
// critical path falls from ndt columns to the widest partition's.
//
// Both take a leading batch axis in the same launch, blockIdx.y the batch
// element (the INLA theta-sweep: B hyperparameter candidates of one
// sparsity pattern): every pointer and the status word are offset by the
// element's stride and nothing else changes, so element i of a batch is
// written bit for bit as the unbatched launch writes it.
//
// The TPU kernel keeps a ring of the last bt panels in VMEM.  Here the last
// bt columns are simply the outputs already written to device memory; at
// bt = nat = 4, T = 64 they are about 0.6 MB and stay in the 50 MB L2, so
// there is no ring.
//
// Bound on this card: operations.  Per column the updates are
// bt(bt+1)/2 + bt*nat + nat(nat+1)/2 tile products.  The diagonal update
// U[0] and the Schur tiles S[i, i] are symmetric, so each of their products
// needs T^3 flops and every other one 2 T^3: the Table II matrix 5 shape
// (ndt = 157, bt = 4, nat = 4, T = 64) needs about 2.94 Gflop (this kernel
// forms the symmetric tiles in full, about 3.27 Gflop) and moves about
// 48 MB: tens of microseconds at the card's fp32 rate, a few at its memory
// rate.  This first design is one block of
// 256 threads, so it is held to the fp32 rate of one SM of 132; its tile
// products are plain FP32 FMAs (no TF32: it keeps about 3 decimal digits)
// from operands staged transposed in shared memory, a 4 x 4 block of
// accumulators a thread at T = 64, with the next operand pair's loads in
// flight during each product.  Spreading a column's independent update tiles over the SMs is
// the next step.
#include "tile.cuh"

// Built with -DSTILES_SWEEP_PHASES (band_cholesky.py::sweep_phase_cycles),
// thread 0 adds the clock64 cycles of each phase of every column into
// g_phase_cycles, each mark behind a block barrier.  The library the main
// path loads is built without it, and its kernel has no marks.
#ifdef STILES_SWEEP_PHASES
__device__ unsigned long long g_phase_cycles[8];
#define PHASE_START long long phase_t0 = clock64()
#define PHASE(i)                                                          \
    do {                                                                  \
        __syncthreads();                                                  \
        if (threadIdx.x == 0) {                                           \
            const long long now = clock64();                              \
            g_phase_cycles[i] += static_cast<unsigned long long>(now - phase_t0); \
            phase_t0 = now;                                               \
        }                                                                 \
    } while (0)
#else
#define PHASE_START do {} while (0)
#define PHASE(i) do {} while (0)
#endif

namespace stiles {

// The partitions' column boundaries, passed by value so that a launch
// needs no device copy of them (and can be captured in a CUDA graph); a
// __grid_constant__ parameter is read in place, without a local copy.
constexpr int kMaxParts = 512;
struct Bounds {
    int b[kMaxParts + 1];
};

template <int T>
constexpr size_t sweep_smem_bytes() {
    // L_kk transposed (T*T) and its diagonal's reciprocals (T), two staged
    // operands (T*LDK each), the factorization's column and pivot (T + 1)
    return sizeof(float) * (T * T + T + 2 * T * Tile<T>::LDK + T + 1);
}

template <int T>
__global__ void __launch_bounds__(kThreads, 1)
band_cholesky_kernel(const float* __restrict__ ac, const float* __restrict__ r_in,
                     float* panels, float* r_out, float* schur, float* status,
                     const __grid_constant__ Bounds bounds, int ndt, int bt, int nat,
                     int csz, int nleaves, int start) {
    extern __shared__ __align__(16) float smem[];
    float* Lt = smem;
    float* dinv = Lt + T * T;
    float* As = dinv + T;
    float* Bs = As + T * Tile<T>::LDK;
    float* colv = Bs + T * Tile<T>::LDK;

    constexpr size_t TT = static_cast<size_t>(T) * T;
    const int b1 = bt + 1;
    // this block's batch element: ndt columns, nleaves Schur leaves and one
    // status word a partition each
    const size_t el = blockIdx.y;
    ac += el * ndt * b1 * TT;
    panels += el * ndt * b1 * TT;
    r_in += el * ndt * nat * TT;
    r_out += el * ndt * nat * TT;
    schur += el * nleaves * nat * nat * TT;
    status += el * 3 * gridDim.x;
    // panels and r_out are written and read back by this block, so they are
    // read with plain (coherent) loads, never through the read-only path
    auto P = [&](int k, int e) { return panels + (static_cast<size_t>(k) * b1 + e) * TT; };
    auto RO = [&](int k, int i) { return r_out + (static_cast<size_t>(k) * nat + i) * TT; };
    auto AC = [&](int k, int e) { return ac + (static_cast<size_t>(k) * b1 + e) * TT; };
    auto RI = [&](int k, int i) { return r_in + (static_cast<size_t>(k) * nat + i) * TT; };
    auto S = [&](int c, int i, int j) {
        return schur + ((static_cast<size_t>(c) * nat + i) * nat + j) * TT;
    };

    // this block's partition [s0, s1); kl is a column's index within it
    const int s0 = bounds.b[blockIdx.x], s1 = bounds.b[blockIdx.x + 1];
    // the status carry lives in thread 0
    float min_piv = INFINITY, nonfinite = 0.f, first_bad = -1.f;
    Acc<T> acc;
    PHASE_START;

    for (int k = s0; k < s1; ++k) {
        const int kl = k - s0;
        const int c = blockIdx.x + kl / csz;
        if (kl % csz == 0) {
            float* sc = S(c, 0, 0);
            for (size_t idx = threadIdx.x; idx < nat * nat * TT; idx += kThreads) sc[idx] = 0.f;
        }
        if (k < start) {
            float* pk = P(k, 0);
            for (size_t idx = threadIdx.x; idx < b1 * TT; idx += kThreads)
                pk[idx] = (idx < TT && idx / T == idx % T) ? 1.f : 0.f;
            float* rk = RO(k, 0);
            for (size_t idx = threadIdx.x; idx < nat * TT; idx += kThreads) rk[idx] = 0.f;
            if (threadIdx.x == 0) min_piv = fminf(min_piv, 1.f);
            __syncthreads();
            continue;
        }
        PHASE(7);  // column start: chunk zeroing
        const int jmax = min(bt, kl);  // columns back within the partition

        // diagonal tile: L_kk = chol(A_kk - sum_j L[k, k-j] L[k, k-j]^T)
        // (pair q of each update is column j = q + 1 back: L[., k-j] L[k, k-j]^T)
        auto Lkj = [&](int q) { return P(k - 1 - q, q + 1); };
        zero_acc<T>(acc);
        gemm_nt_sum<T>(acc, jmax, Lkj, Lkj, As, Bs);
        PHASE(0);  // diagonal products
        Acc<T> lkk;
        load_minus<T>(lkk, AC(k, 0), acc);
        factorize_tile<T>(lkk, colv);
        store_substitution_operands<T>(Lt, dinv, lkk);
        store_tile<T>(P(k, 0), lkk);
        bool bad = owns_tile<T>() && any_nonfinite<T>(lkk);
        PHASE(1);  // potrf

        // right-hand sides of the substitution: band tiles, then arrow rows
        for (int e = 1; e <= bt; ++e) {
            zero_acc<T>(acc);
            gemm_nt_sum<T>(acc, min(bt - e, kl), [&](int q) { return P(k - 1 - q, e + q + 1); },
                           Lkj, As, Bs);
            store_minus<T>(P(k, e), AC(k, e), acc);
        }
        PHASE(2);  // band products
        for (int i = 0; i < nat; ++i) {
            zero_acc<T>(acc);
            gemm_nt_sum<T>(acc, jmax, [&](int q) { return RO(k - 1 - q, i); }, Lkj, As, Bs);
            store_minus<T>(RO(k, i), RI(k, i), acc);
        }
        __syncthreads();  // L_kk and every right-hand side are in place
        PHASE(3);  // arrow products

        // one batched right-substitution of the bt + nat tiles, in place
        const int band_rows = bt * T;
        auto row = [&](int rr) {
            return rr < band_rows ? P(k, 1) + static_cast<size_t>(rr) * T
                                  : RO(k, 0) + static_cast<size_t>(rr - band_rows) * T;
        };
        bad |= substitute_right_rows<T>(Lt, dinv, (bt + nat) * T, row, row);

        // status fold of this column, as the TPU kernel and sweep_status do
        PHASE(4);  // substitution
        const int col_nonfinite = __syncthreads_or(bad);
        if (threadIdx.x < 32) {
            float mn = INFINITY;
            int fin = 1;
            for (int i = threadIdx.x; i < T; i += 32) {
                const float d = Lt[i * T + i];
                fin &= isfinite(d);
                mn = fminf(mn, d * d);
            }
            fin = __all_sync(0xffffffffu, fin);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
            if (threadIdx.x == 0) {
                const float piv = fin ? mn : INFINITY;
                min_piv = fminf(min_piv, piv);
                if (col_nonfinite) nonfinite = 1.f;
                if (first_bad < 0.f && (col_nonfinite || piv <= 0.f))
                    first_bad = static_cast<float>(k);
            }
        }

        PHASE(5);  // status fold
        // corner-Schur partial sum: S[i, j] += L_a[i] L_a[j]^T for j <= i,
        // mirrored into S[j, i] (the same products in the same order)
        for (int i = 0; i < nat; ++i)
            for (int j = 0; j <= i; ++j) {
                zero_acc<T>(acc);
                gemm_nt_sum<T>(acc, 1, [&](int) { return RO(k, i); },
                               [&](int) { return RO(k, j); }, As, Bs);
                store_add<T>(S(c, i, j), acc, false);
                if (j != i) store_add<T>(S(c, j, i), acc, true);
            }
        __syncthreads();  // column k is complete before column k + 1 reads it
        PHASE(6);  // Schur products
    }
    if (threadIdx.x == 0) {
        status[3 * blockIdx.x] = min_piv;
        status[3 * blockIdx.x + 1] = nonfinite;
        status[3 * blockIdx.x + 2] = first_bad;
    }
}

template <int T>
int launch_sweep(const float* ac, const float* r, float* panels, float* r_out, float* schur,
                 float* status, const Bounds& bounds, int nparts, int batch, int ndt, int bt,
                 int nat, int csz, int nleaves, int start, cudaStream_t s) {
    constexpr size_t smem = sweep_smem_bytes<T>();
    cudaError_t err = cudaFuncSetAttribute(band_cholesky_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    band_cholesky_kernel<T><<<dim3(nparts, batch), kThreads, smem, s>>>(
        ac, r, panels, r_out, schur, status, bounds, ndt, bt, nat, csz, nleaves, start);
    return static_cast<int>(cudaGetLastError());
}

int sweep(const void* ac, const void* r, void* panels, void* r_out, void* schur, void* status,
          const Bounds& bounds, int nparts, int batch, int ndt, int bt, int nat, int t, int csz,
          int nleaves, int start, void* stream) {
    if (batch < 1 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const auto* pac = static_cast<const float*>(ac);
    const auto* pr = static_cast<const float*>(r);
    auto* pp = static_cast<float*>(panels);
    auto* pro = static_cast<float*>(r_out);
    auto* ps = static_cast<float*>(schur);
    auto* pst = static_cast<float*>(status);
    auto s = static_cast<cudaStream_t>(stream);
    switch (t) {
        case 8: return launch_sweep<8>(pac, pr, pp, pro, ps, pst, bounds, nparts, batch, ndt, bt, nat,
                                            csz, nleaves, start, s);
        case 16: return launch_sweep<16>(pac, pr, pp, pro, ps, pst, bounds, nparts, batch, ndt, bt, nat,
                                            csz, nleaves, start, s);
        case 32: return launch_sweep<32>(pac, pr, pp, pro, ps, pst, bounds, nparts, batch, ndt, bt, nat,
                                            csz, nleaves, start, s);
        case 64: return launch_sweep<64>(pac, pr, pp, pro, ps, pst, bounds, nparts, batch, ndt, bt, nat,
                                            csz, nleaves, start, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace stiles

// The fused sweep: one block over columns 0..ndt-1, Schur chunks of csz
// columns, status (3,); a batch of `batch` such problems, contiguous one
// after another, in the same launch (one block each).
extern "C" int stiles_band_cholesky_sweep_f32(const void* ac, const void* r, void* panels,
                                              void* r_out, void* schur, void* status,
                                              int ndt, int bt, int nat, int t, int csz,
                                              int start, int batch, void* stream) {
    stiles::Bounds bounds{};
    bounds.b[1] = ndt;
    return stiles::sweep(ac, r, panels, r_out, schur, status, bounds, 1, batch, ndt, bt, nat, t,
                         csz, (ndt + csz - 1) / csz, start, stream);
}

// The partitioned sweep: nparts blocks, block p over columns
// [bounds[p], bounds[p+1]) (bounds: nparts + 1 ints in host memory, rising
// from 0 to ndt), one Schur leaf schur[p] and one status word status[p] each;
// for each of `batch` problems in the same launch.
extern "C" int stiles_band_cholesky_partitioned_sweep_f32(
        const void* ac, const void* r, void* panels, void* r_out, void* schur, void* status,
        const void* bounds, int nparts, int bt, int nat, int t, int start, int batch,
        void* stream) {
    if (nparts < 1 || nparts > stiles::kMaxParts) return static_cast<int>(cudaErrorInvalidValue);
    stiles::Bounds b{};
    const int* hb = static_cast<const int*>(bounds);
    for (int p = 0; p <= nparts; ++p) b.b[p] = hb[p];
    // a chunk as long as the band: one leaf per partition
    const int ndt = hb[nparts];
    return stiles::sweep(ac, r, panels, r_out, schur, status, b, nparts, batch, ndt, bt, nat, t,
                         ndt > 0 ? ndt : 1, nparts, start, stream);
}

#ifdef STILES_SWEEP_PHASES
// Copy the phase cycles out (reset = 1 zeroes them instead).
extern "C" int stiles_sweep_phase_cycles(void* out, int reset) {
    if (reset) {
        const unsigned long long zero[8] = {};
        return static_cast<int>(cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero)));
    }
    return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles)));
}
#endif
