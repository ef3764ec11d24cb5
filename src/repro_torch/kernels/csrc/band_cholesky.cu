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
// Column k of the factorization:
//   U[e] = sum_j L[k+e, k-j] L[k, k-j]^T   (e = 0..bt, j = 1..bt-e)
//   V[i] = sum_j L[ndt+i, k-j] L[k, k-j]^T (j = 1..bt)
//   L_kk = chol(A_kk - U[0])
//   the bt band tiles and nat arrow rows below it: (input - update) L_kk^{-T}
//   schur[k / csz] += L_a L_a^T, the chunk's partial sum
//   the status fold of the TPU kernel
// Columns k < start are an identity-embedding prefix: they emit an identity
// panel and a zero arrow row and do no arithmetic, with one cluster barrier
// after the last of them.
//
// One thread-block cluster of CL blocks (128 threads each) walks the columns
// of one matrix in order, on the plan of kernels/band_cholesky.py::
// sweep_plan, passed as a table in device memory.  Each S x S sub-tile of a
// column's targets (S = min(T, 32): the lower sub-tiles of U[0], every
// sub-tile of the band tiles and arrow rows) and of its corner-Schur tiles
// is a unit, computed whole by one rank, its pairs j = 1.. in order: no sum
// is split across ranks.  Column k:
//   A. each rank computes its sub-tiles of U[0], input minus update, into
//      rank 0's L_kk buffer (distributed shared memory), and arrives at
//      cluster barrier 1 without waiting.  Their pairs with columns
//      k-2, k-3, .. were summed during column k-1 (in the owner's shared
//      memory), so only the pair with column k-1 is on the chain;
//   B. rank 0 waits at barrier 1 and factors L_kk in shared memory
//      (tile.cuh's blocked factorize_smem, potrf.cu's routine), stores it
//      and folds the pivots into the status; meanwhile the other ranks
//      compute their band and arrow sub-tiles into the outputs and add
//      column k-1's Schur products L_a[i] L_a[j]^T (j <= i, mirrored) into
//      the chunk's sum, each Schur sub-tile always on the same rank, so in
//      column order, and then the pairs q >= 1 of their sub-tiles of column
//      k+1's U[0]; the plan counts rank 0 busy for the factorization, so it
//      has the fewest units there;                        cluster barrier 2
//   C. every rank reads L_kk and substitutes its own contiguous run of the
//      (bt + nat) T rows below it in place (tile.cuh's blocked
//      substitute_right, trsm.cu's routine);             cluster barrier 3
// The last column's Schur products follow the loop.  One rank factors L_kk,
// and not every rank alike from the same products: that would put the
// diagonal's bt pairs of three sub-tiles (at T = 64) on every rank, several
// microseconds a column, where splitting barrier 1 into its arrive and wait
// already hides the barrier behind the factorization (PERF.md section 5's
// phase split).
//
// Where the trouble was, and what the design does about it:
//   - ranks read tiles other ranks wrote during the launch (panels, arrow
//     rows, L_kk): every such read goes through L2, cp.async.cg for the
//     products and ld.global.cg (__ldcg) for L_kk and the rows, never an
//     L1-cached load that could be stale; the cluster barrier's release
//     (arrive) and acquire (wait) order the writes, to global and to
//     distributed shared memory, before the reads.  The Schur sums are read
//     back only by the thread that wrote them.
//   - latency: a unit's input tile and a Schur unit's running sums are
//     loaded before its products, and every staging of a tile or of rows
//     has all its loads in flight before its first store to shared memory;
//     a Schur unit's mirror goes through shared memory transposed, so the
//     sums are read and written by rows.  (One stream of pairs across a
//     rank's units, each unit's first copies in flight during the unit
//     before, was tried and was slower: PERF.md section 6.)
//   - bits: no sum is split across ranks, each element's sum runs in a fixed
//     order whichever rank holds it, and a row's substitution does not
//     depend on which rows share its chunk, so the outputs do not depend on
//     the cluster size, the partition count or the batch; two launches give
//     the same bits.
//   - ranks without a target or rows still reach every cluster barrier; the
//     status is folded once, after the loop: each rank keeps the first
//     column whose rows it solved to a non-finite value, and rank 0 reads
//     them through distributed shared memory.
//   - registers: the products' accumulators, the factorization's panel and
//     the substitution's rows live in different phases (ptxas reports the
//     count in chip_smoke.py's build log).
//   - a cluster of 16 needs cudaFuncAttributeNonPortableClusterSizeAllowed;
//     a cluster the card refuses is a launch error, which the wrapper raises.
//
// The partitioned sweep is the same kernel on P clusters.  Cluster p walks
// the columns [bounds[p], bounds[p+1]) of a block-separable band (no band
// tile crosses a cut), with its own Schur leaf schur[p] and its own status
// word; the host folds the P words.  A cluster never reads across its cut: a
// column's pairs stop at the partition's first column, where the fused
// sweep would go on to products with L[k, k-j] = 0 (the zero tiles across
// the cut), after the others.  Those products add exact zeros, so on a
// block-separable input the panels, arrow rows and status are bit-identical
// to the fused sweep's.  The fused sweep is the one-partition case,
// bounds = {0, ndt}; its Schur chunks are csz columns long, the partitioned
// sweep's one partition long.
//
// Both take a leading batch axis in the same launch, blockIdx.y the batch
// element (the INLA theta-sweep: B hyperparameter candidates of one
// sparsity pattern): every pointer and the status word are offset by the
// element's stride and nothing else changes, so element i of a batch is
// written bit for bit as the unbatched launch writes it.
//
// The TPU kernel keeps a ring of the last bt panels in VMEM.  Here the last
// bt columns are simply the outputs already written to device memory; at
// bt = nat = 4, T = 64 they are about 0.6 MB and stay in the 50 MB L2.
//
// Bound on this card: operations.  Per column the updates are
// bt(bt+1)/2 + bt*nat + nat(nat+1)/2 tile products.  The diagonal update
// U[0] and the Schur tiles S[i, i] are symmetric, so each of their products
// needs T^3 flops and every other one 2 T^3: the Table II matrix 5 shape
// (ndt = 157, bt = 4, nat = 4, T = 64) needs about 2.94 Gflop and moves
// about 48 MB: tens of microseconds at the card's fp32 rate.  Each column is
// a chain (its products, then L_kk, then the substitution, each reading the
// one before), so the design spreads a column over CL SMs and leaves the
// chain's latency: the products are plain FP32 FMAs (no TF32) from operands
// staged by cp.async into a double buffer (tile_sum.cuh's sum_pairs).
#include "tile_sum.cuh"

// Built with -DSTILES_SWEEP_PHASES (band_cholesky.py::sweep_phase_cycles),
// thread 0 of every rank adds the clock64 cycles of each phase of every
// column into g_phase_cycles[rank], each mark behind a block barrier; the
// waits at the cluster barriers are a phase of their own.  The library the
// main path loads is built without it, and its kernel has no marks.
#ifdef STILES_SWEEP_PHASES
constexpr int kPhases = 7;
__device__ unsigned long long g_phase_cycles[16 * kPhases];
#define PHASE_START long long phase_t0 = clock64()
#define PHASE(i)                                                                      \
    do {                                                                              \
        __syncthreads();                                                              \
        if (threadIdx.x == 0) {                                                       \
            const long long now = clock64();                                          \
            g_phase_cycles[rank * kPhases + (i)] +=                                   \
                static_cast<unsigned long long>(now - phase_t0);                      \
            phase_t0 = now;                                                           \
        }                                                                             \
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

// A unit of the plan's table: kind | a << 8 | b << 16 | sub << 24, sub the
// sub-tile (row * NS + column), kind the band tile e = a of the column
// (e = 0: U[0]), the arrow row i = a, or (2) the Schur tile (i, j) = (a, b),
// j <= i, of the units' lists in turn
constexpr int kBandUnit = 0;
constexpr int kArrowUnit = 1;

__device__ __forceinline__ bool is_diag(int code) {
    return (code & 0xffff) == kBandUnit;   // the band tile e = 0
}

template <int T>
struct SweepShape {
    using Sh = SumShape<T>;
    static constexpr int STAGE = Sh::S * Sh::LDK;               // one staged operand
    static constexpr int ROWS = kSubChunk * Panel<T>::LD;       // rows being solved
    static constexpr int WORK = 4 * STAGE > ROWS ? 4 * STAGE : ROWS;
    // a partial sum of each lower sub-tile of U[0], a thread's share apart
    static constexpr int DPART = Sh::NS * (Sh::NS + 1) / 2 * kSumThreads * Sh::MR * Sh::MC;
    // the products' stages or the rows being solved; L_kk (row stride
    // T + 1); the diagonal's partial sums; L_kk's pivots' reciprocals; the
    // status flag
    static constexpr size_t SMEM = sizeof(float) * (WORK + T * Panel<T>::LD + DPART + T + 4);
};

template <int T>
__global__ void __launch_bounds__(kSumThreads, 1)
band_cholesky_kernel(const float* __restrict__ ac, const float* __restrict__ r_in,
                     float* panels, float* r_out, float* schur, float* status,
                     const int* __restrict__ plan, const __grid_constant__ Bounds bounds,
                     int ndt, int bt, int nat, int csz, int nleaves, int start) {
    using Sh = SumShape<T>;
    using W = SweepShape<T>;
    constexpr int S = Sh::S, NS = Sh::NS, MR = Sh::MR, MC = Sh::MC, NTY = Sh::NTY;
    constexpr int STAGE = W::STAGE, LD = Panel<T>::LD;
    constexpr int NT = kSumThreads;
    constexpr size_t TT = static_cast<size_t>(T) * T;
    extern __shared__ __align__(16) float smem[];
    float* work = smem;                       // As, Bs (two stages each), or the rows X
    float* As = work;
    float* Bs = work + 2 * STAGE;
    float* Lk = work + W::WORK;
    float* dpart = Lk + T * LD;               // this rank's partial sums of U[0]
    float* dinv = dpart + W::DPART;
    int* flag = reinterpret_cast<int*>(dinv + T);
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    const int cl = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int part = blockIdx.x / cl;

    const int b1 = bt + 1;
    // this cluster's batch element: ndt columns, nleaves Schur leaves and one
    // status word a partition each
    const size_t el = blockIdx.y;
    ac += el * ndt * b1 * TT;
    panels += el * ndt * b1 * TT;
    r_in += el * ndt * nat * TT;
    r_out += el * ndt * nat * TT;
    schur += el * nleaves * nat * nat * TT;
    status += el * 3 * (gridDim.x / cl);
    // panels, r_out and schur are written and read back during the launch:
    // no __restrict__, and reads of another rank's tiles go through L2
    auto P = [&](int k, int e) { return panels + (static_cast<size_t>(k) * b1 + e) * TT; };
    auto RO = [&](int k, int i) { return r_out + (static_cast<size_t>(k) * nat + i) * TT; };
    auto AC = [&](int k, int e) { return ac + (static_cast<size_t>(k) * b1 + e) * TT; };
    auto RI = [&](int k, int i) { return r_in + (static_cast<size_t>(k) * nat + i) * TT; };
    auto SC = [&](int c, int i, int j) {
        return schur + ((static_cast<size_t>(c) * nat + i) * nat + j) * TT;
    };

    // this rank's share of the plan: its target units (those of U[0]
    // first), its Schur units and its run of the substitution's rows
    const int* hdr = plan;
    const int t0 = hdr[rank], t1 = hdr[rank + 1];
    const int u0 = hdr[cl + 1 + rank], u1 = hdr[cl + 2 + rank];
    const int row_lo = hdr[2 * cl + 2 + rank], row_hi = hdr[2 * cl + 3 + rank];
    int nd = 0;   // this rank's sub-tiles of U[0]
    while (t0 + nd < t1 && is_diag(plan[t0 + nd])) ++nd;
    // this cluster's partition [s0, s1); kl is a column's index within it
    const int s0 = bounds.b[part], s1 = bounds.b[part + 1];
    const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
    const bool active = threadIdx.x < Sh::ACTIVE;
    // the status carry: rank 0's thread 0 folds the pivots; thread 0 of
    // every rank keeps the first column whose rows it solved to a
    // non-finite value
    float min_piv = INFINITY, nonfinite = 0.f, first_bad = -1.f;
    int first_nf = -1;
    float* lk0 = cluster.map_shared_rank(Lk, 0);   // rank 0's L_kk buffer
    PHASE_START;

    // acc += the pairs lo .. lo + len - 1 of a target sub-tile of column k;
    // pair q is column j = q + 1 back: L[., k-j] L[k, k-j]^T.  Returns with
    // the stages free again.
    auto unit_sum = [&](float (&acc)[MR][MC], int code, int k, int lo, int len) {
        const int a = (code >> 8) & 0xff, sub = code >> 24;
        const bool arrow = (code & 0xff) == kArrowUnit;
        sum_pairs<T, true>(
            acc,
            [&](int q) -> const float* { return arrow ? RO(k - 1 - q, a) : P(k - 1 - q, a + q + 1); },
            [&](int q) -> const float* { return P(k - 1 - q, q + 1); }, lo, len,
            sub / NS * S, sub % NS * S, As, Bs);
        __syncthreads();
    };
    // this thread's partial sum of a sub-tile of U[0]
    auto slot = [&](int code) {
        const int r = (code >> 24) / NS, c = (code >> 24) % NS;
        return dpart + (r * (r + 1) / 2 + c) * NT * MR * MC + threadIdx.x * MR * MC;
    };
    // a target sub-tile of column k: input minus the sum of its pairs, the
    // input read before the products so its latency hides behind theirs; a
    // sub-tile of the diagonal update goes straight into rank 0's L_kk
    // buffer (distributed shared memory), the others into the outputs.  A
    // diagonal sub-tile sums its pairs q = 1.. first and q = 0 last: the
    // column before has left the first part in dpart (`partial`), and only
    // the pair with the column just solved is left on the chain.
    auto target = [&](int code, int k, int kl, bool partial) {
        const int a = (code >> 8) & 0xff, sub = code >> 24;
        const bool arrow = (code & 0xff) == kArrowUnit, diag = !arrow && a == 0;
        const int r0 = sub / NS * S, c0 = sub % NS * S;
        const int n = min(arrow ? bt : bt - a, kl);
        const float* src = arrow ? RI(k, a) : AC(k, a);
        float in[MR][MC], acc[MR][MC];
#pragma unroll
        for (int i = 0; i < MR; ++i)
#pragma unroll
            for (int j = 0; j < MC; ++j) {
                in[i][j] = active ? src[static_cast<size_t>(r0 + ty + NTY * i) * T + c0 + tx + 8 * j]
                                  : 0.f;
                acc[i][j] = partial && active ? slot(code)[i * MC + j] : 0.f;
            }
        if (!diag) {
            unit_sum(acc, code, k, 0, n);
        } else {
            if (!partial && n > 1) unit_sum(acc, code, k, 1, n - 1);
            if (n > 0) unit_sum(acc, code, k, 0, 1);
        }
        float* dst = arrow ? RO(k, a) : P(k, a);
        if (active) {
#pragma unroll
            for (int i = 0; i < MR; ++i)
#pragma unroll
                for (int j = 0; j < MC; ++j) {
                    const int row = r0 + ty + NTY * i, col = c0 + tx + 8 * j;
                    const float v = in[i][j] - acc[i][j];
                    if (diag) {
                        lk0[row * LD + col] = v;
                    } else {
                        dst[static_cast<size_t>(row) * T + col] = v;
                    }
                }
        }
    };
    // the pairs q = 1.. of a sub-tile of U[0] of column k, into dpart
    auto diag_partial = [&](int code, int k, int kl) {
        float acc[MR][MC];
#pragma unroll
        for (int i = 0; i < MR; ++i)
#pragma unroll
            for (int j = 0; j < MC; ++j) acc[i][j] = 0.f;
        const int n = min(bt, kl);
        if (n > 1) unit_sum(acc, code, k, 1, n - 1);
        if (active) {
#pragma unroll
            for (int i = 0; i < MR; ++i)
#pragma unroll
                for (int j = 0; j < MC; ++j) slot(code)[i * MC + j] = acc[i][j];
        }
    };
    // a Schur sub-tile of column kk added to its chunk's sum (stored when kk
    // opens the chunk), and mirrored; `zero`: a prefix column, whose arrow
    // rows are zero, only opens the chunk.  The sums so far are read before
    // the product, and the mirror's share goes through shared memory
    // transposed, so every access to the sums is by rows.
    auto schur_unit = [&](int code, int kk, bool zero) {
        const int i = (code >> 8) & 0xff, j = (code >> 16) & 0xff, sub = code >> 24;
        const int r0 = sub / NS * S, c0 = sub % NS * S;
        const int c = part + (kk - s0) / csz;
        const bool first = (kk - s0) % csz == 0, mirror = i != j || r0 != c0;
        float* sij = SC(c, i, j);
        float* sji = SC(c, j, i);
        // element (ty + NTY ii, tx + 8 jj) of the sub-tile at (r0, c0) of
        // S(i, j), and of the sub-tile at (c0, r0) of S(j, i)
        auto at = [&](float* s, int rr, int cc, int ii, int jj) -> float& {
            return s[static_cast<size_t>(rr + ty + NTY * ii) * T + cc + tx + 8 * jj];
        };
        float oij[MR][MC], oji[MR][MC], acc[MR][MC];
#pragma unroll
        for (int ii = 0; ii < MR; ++ii)
#pragma unroll
            for (int jj = 0; jj < MC; ++jj) {
                oij[ii][jj] = active && !first ? at(sij, r0, c0, ii, jj) : 0.f;
                oji[ii][jj] = active && !first && mirror ? at(sji, c0, r0, ii, jj) : 0.f;
                acc[ii][jj] = 0.f;
            }
        if (!zero) {
            sum_pairs<T, true>(acc, [&](int) -> const float* { return RO(kk, i); },
                               [&](int) -> const float* { return RO(kk, j); }, 0, 1, r0, c0,
                               As, Bs);
            __syncthreads();
        }
        float* tr = As;   // the product's transpose, row stride S + 1
        if (mirror) {
            if (active) {
#pragma unroll
                for (int ii = 0; ii < MR; ++ii)
#pragma unroll
                    for (int jj = 0; jj < MC; ++jj)
                        tr[(ty + NTY * ii) * (S + 1) + tx + 8 * jj] = acc[ii][jj];
            }
            __syncthreads();
        }
        if (active) {
#pragma unroll
            for (int ii = 0; ii < MR; ++ii)
#pragma unroll
                for (int jj = 0; jj < MC; ++jj) {
                    at(sij, r0, c0, ii, jj) = oij[ii][jj] + acc[ii][jj];
                    if (mirror)
                        at(sji, c0, r0, ii, jj) =
                            oji[ii][jj] + tr[(tx + 8 * jj) * (S + 1) + ty + NTY * ii];
                }
        }
        if (mirror) __syncthreads();  // the stages are free for the next unit
    };

    const int band_rows = bt * T;   // the substitution's band rows, then arrow rows

    for (int k = s0; k < s1; ++k) {
        const int kl = k - s0;
        if (k < start) {
            // the identity prefix, spread over the ranks
            float* pk = P(k, 0);
            for (size_t idx = rank * NT + threadIdx.x; idx < b1 * TT; idx += cl * NT)
                pk[idx] = (idx < TT && idx / T == idx % T) ? 1.f : 0.f;
            float* rk = RO(k, 0);
            for (size_t idx = rank * NT + threadIdx.x; idx < nat * TT; idx += cl * NT)
                rk[idx] = 0.f;
            if (kl % csz == 0)
                for (int u = u0; u < u1; ++u) schur_unit(plan[u], k, true);
            if (rank == 0 && threadIdx.x == 0) min_piv = fminf(min_piv, 1.f);
            // no prefix column reads another: one barrier after the last,
            // before the first real column reads their panels
            if (k + 1 == start || k + 1 == s1) cluster.sync();
            continue;
        }
        PHASE(6);  // column start
        // column k - 1 summed the pairs q >= 1 of U[0] unless it was a prefix
        // column or in another partition
        const bool after = kl > 0 && k - 1 >= start;

        // A: this rank's sub-tiles of U[0], into rank 0's L_kk buffer
        for (int u = t0; u < t0 + nd; ++u) target(plan[u], k, kl, after);
        PHASE(0);
        cluster_arrive();  // barrier 1: U[0] is in place
        if (rank == 0) {
            // B: rank 0 factors L_kk while the others go on
            cluster_wait();
            PHASE(5);
            factorize_smem<T, NT>(Lk);
            const bool bad = store_lower<T, NT>(P(k, 0), Lk);
            store_pivots<T, NT>(dinv, Lk);
            // status fold of this column's pivots, as the TPU kernel and
            // sweep_status do; the substituted rows are folded after the loop
            const int col_bad = __syncthreads_or(bad);
            if (threadIdx.x < 32) {
                float mn = INFINITY;
                int fin = 1;
                for (int i = threadIdx.x; i < T; i += 32) {
                    const float d = Lk[i * (LD + 1)];
                    fin &= isfinite(d);
                    mn = fminf(mn, d * d);
                }
                fin = __all_sync(0xffffffffu, fin);
#pragma unroll
                for (int o = 16; o > 0; o >>= 1)
                    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
                if (threadIdx.x == 0) {
                    const float piv = fin ? mn : INFINITY;
                    min_piv = fminf(min_piv, piv);
                    if (col_bad) nonfinite = 1.f;
                    if (first_bad < 0.f && (col_bad || piv <= 0.f))
                        first_bad = static_cast<float>(k);
                }
            }
            PHASE(1);
        }
        // this rank's band and arrow sub-tiles, column k - 1's Schur
        // products, and the pairs q >= 1 of its sub-tiles of column k + 1's
        // U[0]
        for (int u = t0 + nd; u < t1; ++u) target(plan[u], k, kl, false);
        if (after)
            for (int u = u0; u < u1; ++u) schur_unit(plan[u], k - 1, false);
        if (k + 1 < s1)
            for (int u = t0; u < t0 + nd; ++u) diag_partial(plan[u], k + 1, kl + 1);
        PHASE(2);
        if (rank != 0) cluster_wait();
        cluster.sync();  // barrier 2: L_kk and every right-hand side are in place
        PHASE(5);

        // C: every rank's rows, solved against L_kk in place
        if (rank != 0) {
            stage_padded<T, NT>(Lk, P(k, 0));
            __syncthreads();
            store_pivots<T, NT>(dinv, Lk);
        }
        PHASE(3);
        auto rows = [&](int r) {
            const int rr = row_lo + r;
            return rr < band_rows ? P(k, 1) + static_cast<size_t>(rr) * T
                                  : RO(k, 0) + static_cast<size_t>(rr - band_rows) * T;
        };
        const bool bad = substitute_right<T, NT>(work, Lk, dinv, row_hi - row_lo, rows, rows);
        if (__syncthreads_or(bad) && threadIdx.x == 0 && first_nf < 0) first_nf = k;
        PHASE(4);
        cluster.sync();  // barrier 3: column k is complete before column k + 1 reads it
        PHASE(5);
    }
    // the last column's Schur products
    if (s1 - 1 >= start)
        for (int u = u0; u < u1; ++u) schur_unit(plan[u], s1 - 1, false);
    PHASE(2);

    // the status word: rank 0 folds every rank's first non-finite column
    if (threadIdx.x == 0) *flag = first_nf;
    cluster.sync();
    if (rank == 0 && threadIdx.x == 0) {
        for (int r = 0; r < cl; ++r) {
            const int f = *cluster.map_shared_rank(flag, r);
            if (f >= 0) {
                nonfinite = 1.f;
                if (first_bad < 0.f || static_cast<float>(f) < first_bad)
                    first_bad = static_cast<float>(f);
            }
        }
        status[3 * part] = min_piv;
        status[3 * part + 1] = nonfinite;
        status[3 * part + 2] = first_bad;
    }
    cluster.sync();  // rank 0 has read every rank's flag
    PHASE(6);
}

template <int T>
cudaError_t prepare_sweep(int cl) {
    cudaError_t err = cudaFuncSetAttribute(band_cholesky_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(SweepShape<T>::SMEM));
    if (err == cudaSuccess && cl > kMaxCluster)
        err = cudaFuncSetAttribute(band_cholesky_kernel<T>,
                                   cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return err;
}

template <int T>
cudaError_t launch_sweep(const float* ac, const float* r, float* panels, float* r_out,
                         float* schur, float* status, const int* plan, int cl,
                         const Bounds& bounds, int nparts, int batch, int ndt, int bt, int nat,
                         int csz, int nleaves, int start, cudaStream_t s) {
    const cudaError_t err = prepare_sweep<T>(cl);
    if (err != cudaSuccess) return err;
    return launch_cluster(band_cholesky_kernel<T>, dim3(nparts * cl, batch), cl,
                          SweepShape<T>::SMEM, s, ac, r, panels, r_out, schur, status, plan,
                          bounds, ndt, bt, nat, csz, nleaves, start);
}

// How many clusters of cl blocks of the sweep the card holds at once.
template <int T>
cudaError_t max_active_clusters(int cl, int* out) {
    cudaError_t err = prepare_sweep<T>(cl);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cl);
    cfg.blockDim = dim3(kSumThreads);
    cfg.dynamicSmemBytes = SweepShape<T>::SMEM;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaOccupancyMaxActiveClusters(out, band_cholesky_kernel<T>, &cfg);
}

int sweep(const void* ac, const void* r, void* panels, void* r_out, void* schur, void* status,
          const void* plan, int cl, const Bounds& bounds, int nparts, int batch, int ndt, int bt,
          int nat, int t, int csz, int nleaves, int start, void* stream) {
    if (batch < 1 || batch > 65535 || cl < 1 || cl > kMaxClusterNonPortable || plan == nullptr ||
        bt < 0 || bt > 255 || nat < 0 || nat > 255)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto* pac = static_cast<const float*>(ac);
    const auto* pr = static_cast<const float*>(r);
    auto* pp = static_cast<float*>(panels);
    auto* pro = static_cast<float*>(r_out);
    auto* ps = static_cast<float*>(schur);
    auto* pst = static_cast<float*>(status);
    const auto* pln = static_cast<const int*>(plan);
    auto s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (t) {
        case 8: err = launch_sweep<8>(pac, pr, pp, pro, ps, pst, pln, cl, bounds, nparts, batch,
                                      ndt, bt, nat, csz, nleaves, start, s); break;
        case 16: err = launch_sweep<16>(pac, pr, pp, pro, ps, pst, pln, cl, bounds, nparts, batch,
                                        ndt, bt, nat, csz, nleaves, start, s); break;
        case 32: err = launch_sweep<32>(pac, pr, pp, pro, ps, pst, pln, cl, bounds, nparts, batch,
                                        ndt, bt, nat, csz, nleaves, start, s); break;
        case 64: err = launch_sweep<64>(pac, pr, pp, pro, ps, pst, pln, cl, bounds, nparts, batch,
                                        ndt, bt, nat, csz, nleaves, start, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace stiles

// The fused sweep: one cluster of `cluster` blocks over columns 0..ndt-1 on
// the plan table `plan` (device memory), Schur chunks of csz columns,
// status (3,); a batch of `batch` such problems, contiguous one after
// another, in the same launch (one cluster each).
extern "C" int stiles_band_cholesky_sweep_f32(const void* ac, const void* r, void* panels,
                                              void* r_out, void* schur, void* status,
                                              const void* plan, int cluster, int ndt, int bt,
                                              int nat, int t, int csz, int start, int batch,
                                              void* stream) {
    stiles::Bounds bounds{};
    bounds.b[1] = ndt;
    return stiles::sweep(ac, r, panels, r_out, schur, status, plan, cluster, bounds, 1, batch,
                         ndt, bt, nat, t, csz, (ndt + csz - 1) / csz, start, stream);
}

// The partitioned sweep: nparts clusters, cluster p over columns
// [bounds[p], bounds[p+1]) (bounds: nparts + 1 ints in host memory, rising
// from 0 to ndt), one Schur leaf schur[p] and one status word status[p] each;
// for each of `batch` problems in the same launch.
extern "C" int stiles_band_cholesky_partitioned_sweep_f32(
        const void* ac, const void* r, void* panels, void* r_out, void* schur, void* status,
        const void* plan, int cluster, const void* bounds, int nparts, int bt, int nat, int t,
        int start, int batch, void* stream) {
    if (nparts < 1 || nparts > stiles::kMaxParts) return static_cast<int>(cudaErrorInvalidValue);
    stiles::Bounds b{};
    const int* hb = static_cast<const int*>(bounds);
    for (int p = 0; p <= nparts; ++p) b.b[p] = hb[p];
    // a chunk as long as the band: one leaf per partition
    const int ndt = hb[nparts];
    return stiles::sweep(ac, r, panels, r_out, schur, status, plan, cluster, b, nparts, batch,
                         ndt, bt, nat, t, ndt > 0 ? ndt : 1, nparts, start, stream);
}

// How many clusters of `cluster` blocks of the sweep at tile size t the card
// holds at once (cudaOccupancyMaxActiveClusters), into *out.
extern "C" int stiles_sweep_max_active_clusters(int t, int cluster, void* out) {
    using namespace stiles;
    if (cluster < 1 || cluster > kMaxClusterNonPortable)
        return static_cast<int>(cudaErrorInvalidValue);
    int* o = static_cast<int*>(out);
    switch (t) {
        case 8: return static_cast<int>(max_active_clusters<8>(cluster, o));
        case 16: return static_cast<int>(max_active_clusters<16>(cluster, o));
        case 32: return static_cast<int>(max_active_clusters<32>(cluster, o));
        case 64: return static_cast<int>(max_active_clusters<64>(cluster, o));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

#ifdef STILES_SWEEP_PHASES
// Copy the phase cycles out, 16 ranks x kPhases (reset = 1 zeroes them
// instead).
extern "C" int stiles_sweep_phase_cycles(void* out, int reset) {
    if (reset) {
        const unsigned long long zero[16 * kPhases] = {};
        return static_cast<int>(cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero)));
    }
    return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles)));
}
#endif
