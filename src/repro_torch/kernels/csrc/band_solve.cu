// The multi-RHS band sweeps of a banded-arrowhead factor, each in one launch.
//
// Replaces the TPU kernels src/repro/kernels/band_solve.py::
// band_forward_sweep_pallas (body _band_forward_kernel) and
// band_backward_sweep_pallas (body _band_backward_kernel).
//
// Inputs are the row-band factor tiles dr (ndt, bt+1, T, T), dr[m, j] =
// L[m, m-j], and the arrow rows r (ndt, nat, T, T).  Forward, with the
// right-hand sides bd (ndt, T, k):
//   Y_m = L_mm^{-1} (B_m - sum_{j=1..bt} L[m, m-j] Y_{m-j}),  m = start..ndt-1
//   acc_a[i] = sum_m R[m, i] Y_m
// Backward, with yd (ndt, T, k) and the solved arrow panel xa (nat, T, k):
//   X_m = L_mm^{-T} (Y_m - sum_j L[m+j, m]^T X_{m+j} - sum_i R[m, i]^T Xa_i),
//   m = ndt-1..start, reading L[m+j, m] in place as dr[m+j, j]
// Rows m < start (an identity prefix with zero right-hand side) are written
// as zeros and skipped.
//
// A batch of such problems, each element's dr, r, right-hand side (and xa)
// contiguous after the one before, is the same launch with blockIdx.y the
// element: the element's pointer offsets are the only change, so element i
// is written bit for bit as the unbatched launch on the same plan writes it.
//
// The columns of the right-hand side are independent, so the grid is one
// thread-block cluster for each chunk of W of them (W = 1, 2, 4 or 8: the
// narrowest whose clusters the card holds at once, one block an SM), on
// the plan of kernels/band_solve.py::solve_plan, passed as a table of each
// rank's units.  Which row a unit's product reads and writes in a phase is
// worked out here (job, has_chain, has_partial), not read from the plan.
// Row m of the sweep is a chain: it needs the row solved just before it.
// Only that part is on rank 0:
//   rhs_m = (B_m - S_m) - C_m,   Y_m = L_mm^{-1} rhs_m,
// C_m the one product with the row just solved (forward L[m, m-1] Y_{m-1},
// backward L[m+1, m]^T X_{m+1}), S_m the sum of every other product of the
// row, which the other ranks add up ahead of it in rank 0's shared memory
// (distributed shared memory), one slot a row, each product whole on one
// rank and added in phase order.  The sweep runs in phases, one cluster
// barrier each (split into its arrive and its wait): in the phase of row m,
//   - rank 0 multiplies C_m from the panel it solved in the phase before
//     (still in its shared memory) and the factor tile it staged then,
//     waits at the barrier, forms rhs_m, substitutes it against L_mm
//     (tile.cuh's blocked solve_few_rows, pivots precomputed) and keeps the
//     solved panel for the next phase; the next row's tiles and right-hand
//     side are copied in by cp.async meanwhile;
//   - every other rank copies the panel published in the phase before from
//     rank 0's shared memory and computes its units with it: forward the
//     look-ahead products L[s+j, s] Y_s (j = 2..bt) into S_{s+j} and the
//     arrow sums R[s, i] Y_s into acc_a[i] (each arrow tile on one rank, its
//     sum over s in ascending order, in the output); backward the
//     look-ahead products L[s, s-j]^T X_s into S_{s-j} and the arrow terms
//     R[m, i]^T Xa_i, product i of row m nat - i phases before the row's
//     first band product, so S_m = sum_i (in order) + sum_j (descending j).
//     A unit's factor tile is copied in before the barrier's wait.
// The backward sweep opens with `lead` phases in which only the arrow terms
// of its first rows are computed; the forward sweep closes with one for the
// last row's arrow products.
//
// Where the trouble was, and what the design does about it:
//   - latency: the first design walked every row on one block, all its
//     products and a one-warp T-step substitution on the chain (about 30 us
//     a row at T = 64).  Here the chain is one narrow product, one blocked
//     substitution and one cluster barrier, whose wait comes after C_m: the
//     barrier's latency hides behind the product.
//   - the columns: a chunk is at most W wide whatever k, so k = 1 pays a
//     product of a vector, not of a 32-column panel, and k = 32 spreads over
//     8 clusters of 8 blocks (Table II matrix 5) or 16 of 5 (matrix 2); a
//     batch of B counts B times the clusters when the width is picked.  A
//     product is spread over the block as (4-row quad, column) outputs, the
//     contraction split over KS lanes and summed by shuffles.
//   - bits: every product is computed by the same code whichever rank holds
//     it, and S_m is added up in phase order, so the result does not depend
//     on the cluster size; two launches give the same bits.
//   - ranks read each other's writes (the solved panel, the slots) only
//     through distributed shared memory, after the barrier's release
//     (arrive) and acquire (wait).  A panel and a slot are not reused
//     before the barrier after their last reader: panels alternate by row
//     parity, slots are a ring of lead + 1.
//   - the backward sweep reads L[m+j, m] as dr[m+j, j] in place: no gather.
//
// Bound on this card: bytes at small k.  Table II matrix 5 (ndt = 157,
// bt = 4, nat = 4, T = 64) has about 23 MB of factor tiles, which the card
// could read in 7 us; its products are about 2 T^2 k (bt + nat + 1/2)
// operations a row.  The chain's latency, 157 rows each a product, a
// substitution and a barrier, is what the time is made of.
#include "tile_sum.cuh"

namespace stiles {

constexpr int kSolveThreads = 256;
constexpr int kUnitBufs = 2;           // a rank's ring of staged unit operands
// a unit's code in the plan's table: kind | index << 8, kind 0 the
// look-ahead product with band tile j = index, 1 the arrow tile i = index
constexpr int kArrowUnit = 1;

template <int T, int W>
struct SolveShape {
    static constexpr int LDA = T + 4;           // a staged factor tile: 16-byte rows
    static constexpr int LDZ = T + 4;           // a panel: row c is right-hand side c
    static constexpr int TILE = T * LDA, PANEL = W * LDZ;
    static constexpr int QUADS = T / 4;
    static constexpr int QC = QUADS * W;        // (4-row quad, column) outputs of a product
    static constexpr int KS_ = kSolveThreads / QC;
    static constexpr int KS = KS_ > QUADS ? QUADS : KS_;   // lanes splitting a contraction
    static_assert(QC <= kSolveThreads && KS >= 1 && KS <= 32, "a product's outputs per block");
    // floats of shared memory beside the slots: the chain's product tile,
    // L_mm and right-hand side, two rows each; rank 0's solved panels, two;
    // the units' ring, a tile and a panel each; the published panel's copy;
    // the pivots
    static constexpr int FIXED = 4 * TILE + 4 * PANEL + kUnitBufs * (TILE + PANEL) + PANEL + T;
};

// A row-major T x T tile into S at row stride T + 4, 16 bytes a copy.
template <int T>
__device__ __forceinline__ void stage_tile16(float* S, const float* src) {
    constexpr int C4 = T / 4;
    for (int v = threadIdx.x; v < T * C4; v += kSolveThreads)
        cp_async16(S + (v / C4) * (T + 4) + 4 * (v % C4), src + 4 * v);
}

// Columns c0 .. c0 + W - 1 of a row-major (T, k) panel, transposed:
// P[c * (T + 4) + i] = src[i, c0 + c], zero past column k.
template <int T, int W>
__device__ __forceinline__ void stage_panel(float* P, const float* src, int c0, int k) {
    for (int v = threadIdx.x; v < T * W; v += kSolveThreads) {
        const int c = v % W, i = v / W;
        if (c0 + c < k) {
            cp_async4(P + c * (T + 4) + i, src + static_cast<size_t>(i) * k + c0 + c);
        } else {
            P[c * (T + 4) + i] = 0.f;
        }
    }
}

// This thread's outputs of a tile times a panel: for the (quad q, column c)
// of thread tid / KS, o[u] = sum_l A[4q+u, l] Z[c, l] (TRANS false: the
// tile as it is) or sum_l A[l, 4q+u] Z[c, l] (TRANS true: its transpose),
// A staged at row stride T + 4 and Z a panel.  The KS lanes of a (q, c)
// take every KS-th 4-column step (TRANS false) or row (TRANS true) of the
// contraction, in order, and are summed by an xor butterfly, so every lane
// holds the sum; lane ks = 0 writes it.  Every thread of the block calls it.
template <int T, int W, bool TRANS>
__device__ __forceinline__ void tile_times_panel(float (&o)[4], const float* A, const float* Z) {
    using S = SolveShape<T, W>;
    const int ks = threadIdx.x % S::KS, qc = threadIdx.x / S::KS;
#pragma unroll
    for (int u = 0; u < 4; ++u) o[u] = 0.f;
    if (qc < S::QC) {
        const int q = qc / W;
        const float* z = Z + qc % W * S::LDZ;
        if constexpr (!TRANS) {
#pragma unroll 4
            for (int lq = ks; lq < S::QUADS; lq += S::KS) {
                const float4 zv = *reinterpret_cast<const float4*>(z + 4 * lq);
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const float4 a =
                        *reinterpret_cast<const float4*>(A + (4 * q + u) * S::LDA + 4 * lq);
                    o[u] = fmaf(a.x, zv.x, o[u]);
                    o[u] = fmaf(a.y, zv.y, o[u]);
                    o[u] = fmaf(a.z, zv.z, o[u]);
                    o[u] = fmaf(a.w, zv.w, o[u]);
                }
            }
        } else {
#pragma unroll 4
            for (int l = ks; l < T; l += S::KS) {
                const float4 a = *reinterpret_cast<const float4*>(A + l * S::LDA + 4 * q);
                const float zl = z[l];
                o[0] = fmaf(a.x, zl, o[0]);
                o[1] = fmaf(a.y, zl, o[1]);
                o[2] = fmaf(a.z, zl, o[2]);
                o[3] = fmaf(a.w, zl, o[3]);
            }
        }
    }
#pragma unroll
    for (int off = S::KS / 2; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < 4; ++u) o[u] += __shfl_xor_sync(0xffffffffu, o[u], off);
}

// One unit of a phase: its tile, its own panel (the backward arrow term's
// Xa_i; else the published panel), its target (the row of the slot, or the
// forward arrow tile) and whether it is the target's first term.
struct Job {
    const float* a;
    const float* z;
    int target;
    bool first;
};

template <int T, int W, bool BACK>
__global__ void __launch_bounds__(kSolveThreads, 1)
band_sweep_kernel(const float* __restrict__ dr, const float* __restrict__ r_in,
                  const float* __restrict__ rhs, const float* __restrict__ xa, float* out,
                  float* acca, const int* __restrict__ plan, int ndt, int bt, int nat, int k,
                  int start, int lead) {
    using S = SolveShape<T, W>;
    constexpr int NT = kSolveThreads, LDA = S::LDA, LDZ = S::LDZ, TILE = S::TILE;
    constexpr int PANEL = S::PANEL, UNIT = TILE + PANEL;
    constexpr size_t TT = static_cast<size_t>(T) * T;
    {   // this cluster's batch element
        const size_t el = blockIdx.y, rows = static_cast<size_t>(ndt) * T * k;
        dr += el * ndt * (bt + 1) * TT;
        r_in += el * ndt * nat * TT;
        rhs += el * rows;
        out += el * rows;
        if (xa) xa += el * nat * T * k;
        if (acca) acca += el * nat * T * k;
    }
    extern __shared__ __align__(16) float smem[];
    float* c1 = smem;                        // the chain product's tile, by row parity
    float* lk = c1 + 2 * TILE;               // L_mm, by row parity
    float* binit = lk + 2 * TILE;            // B_m (backward Y_m), by row parity
    float* zb = binit + 2 * PANEL;           // rank 0's solved panels, by row parity
    float* ring = zb + 2 * PANEL;            // the units' operands
    float* zl = ring + kUnitBufs * UNIT;     // the published panel, copied from rank 0
    float* dinv = zl + PANEL;                // L_mm's pivots' reciprocals
    float* slots = dinv + T;                 // rank 0: S_m, a ring of lead + 1 rows
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    const int cl = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int c0 = blockIdx.x / cl * W;
    const int tid = threadIdx.x, nslot = lead + 1, b1 = bt + 1;
    // this thread's output of a product: (quad q, column c) on lane ks = 0
    const int qc = tid / S::KS, q = qc / W, c = qc % W;
    const bool owner = tid % S::KS == 0 && qc < S::QC;
    auto DR = [&](int m, int j) { return dr + (static_cast<size_t>(m) * b1 + j) * TT; };
    auto RR = [&](int m, int i) { return r_in + (static_cast<size_t>(m) * nat + i) * TT; };
    auto at = [&](float* base, int m, int i, int cc) -> float& {   // element (i, c0 + cc) of panel m
        return base[(static_cast<size_t>(m) * T + i) * k + c0 + cc];
    };

    // rows m < start stay zero, spread over the ranks
    const int nz = min(start, ndt);
    for (int v = rank * NT + tid; v < nz * T * W; v += cl * NT) {
        const int cc = v % W;
        if (c0 + cc < k) at(out, v / (W * T), v / W % T, cc) = 0.f;
    }
    if (start >= ndt) {   // no row to solve; uniform over the cluster
        if (!BACK && rank == 0)
            for (int v = tid; v < nat * T * W; v += NT) {
                const int cc = v % W;
                if (c0 + cc < k) at(acca, v / (W * T), v / W % T, cc) = 0.f;
            }
        return;
    }

    auto is_row = [&](int p) { return p >= start && p < ndt; };
    auto has_chain = [&](int m) { return bt >= 1 && (BACK ? m + 1 < ndt : m - 1 >= start); };
    auto has_partial = [&](int m) {
        return BACK ? nat > 0 || min(bt, ndt - 1 - m) >= 2 : min(bt, m - start) >= 2;
    };
    // rank 0: row m's chain operands, one cp.async group
    auto prefetch = [&](int m) {
        const int b = m & 1;
        if (has_chain(m)) stage_tile16<T>(c1 + b * TILE, BACK ? DR(m + 1, 1) : DR(m, 1));
        stage_tile16<T>(lk + b * TILE, DR(m, 0));
        stage_panel<T, W>(binit + b * PANEL, rhs + static_cast<size_t>(m) * T * k, c0, k);
        cp_async_commit();
    };
    // unit `code` in the phase of row p: false if it has nothing to do there
    auto job = [&](int code, int p, Job& jb) -> bool {
        const int idx = code >> 8;
        const bool arrow = (code & 0xff) == kArrowUnit;
        if (!BACK) {
            const int s = p - 1;   // the source row, solved in the phase before
            if (s < start || s >= ndt) return false;
            if (arrow) {
                jb = Job{RR(s, idx), nullptr, idx, s == start};
            } else {
                if (s + idx >= ndt) return false;
                jb = Job{DR(s + idx, idx), nullptr, s + idx, idx == bt || s == start};
            }
            return true;
        }
        if (arrow) {
            const int m = p - (max(bt, 1) + nat - 1 - idx);
            if (m < start || m >= ndt) return false;
            jb = Job{RR(m, idx), xa + static_cast<size_t>(idx) * T * k, m, idx == 0};
            return true;
        }
        const int s = p + 1;
        if (s >= ndt || s - idx < start) return false;
        jb = Job{DR(s, idx), nullptr, s - idx, nat == 0 && (idx == bt || s == ndt - 1)};
        return true;
    };
    // this rank's units; the next one with something to do in phase p
    const int u0 = plan[rank], u1 = plan[rank + 1];
    auto next_job = [&](int p, int u, Job& jb) {
        for (; u < u1; ++u)
            if (job(plan[u], p, jb)) return u;
        return u1;
    };
    auto stage_job = [&](const Job& jb, int b) {
        stage_tile16<T>(ring + b * UNIT, jb.a);
        if (jb.z) stage_panel<T, W>(ring + b * UNIT + TILE, jb.z, c0, k);
        cp_async_commit();
    };

    const int dir = BACK ? -1 : 1;
    const int p0 = BACK ? ndt - 1 + lead : start;
    const int nphase = BACK ? ndt + lead - start : ndt - start + 1;
    if (rank == 0) prefetch(p0 - (BACK ? lead : 0));
    cluster.sync();   // every block runs before any reaches another's shared memory
    float* slots0 = cluster.map_shared_rank(slots, 0);
    const float* zb0 = cluster.map_shared_rank(zb, 0);

#pragma unroll 1
    for (int step = 0; step < nphase; ++step) {
        const int p = p0 + dir * step;
        // this rank's first units' operands, in flight during the wait
        Job ja, jn;
        int ua = next_job(p, u0, ja);
        int un = ua < u1 ? next_job(p, ua + 1, jn) : u1;
        if (ua < u1) stage_job(ja, 0);
        if (un < u1) stage_job(jn, 1);

        if (rank == 0 && is_row(p)) {
            // the chain: row m = p
            const int m = p, b = m & 1;
            cp_async_wait<0>();
            __syncthreads();   // row m's operands have landed
            if (tid < T) dinv[tid] = __frcp_rn(lk[b * TILE + tid * (LDA + 1)]);
            float o[4];
            const bool hc = has_chain(m);
            if (hc) tile_times_panel<T, W, BACK>(o, c1 + b * TILE, zb + (b ^ 1) * PANEL);
            // the next row's operands, in flight during the wait and the row
            if (is_row(m + dir)) prefetch(m + dir);
            if (step > 0) cluster_wait();   // S_m is complete, zb[b] is free
            if (owner) {
                float4 v = *reinterpret_cast<const float4*>(binit + b * PANEL + c * LDZ + 4 * q);
                if (has_partial(m)) {
                    const float4 s4 =
                        *reinterpret_cast<const float4*>(slots + m % nslot * PANEL + c * LDZ + 4 * q);
                    v.x -= s4.x; v.y -= s4.y; v.z -= s4.z; v.w -= s4.w;
                }
                if (hc) {
                    v.x -= o[0]; v.y -= o[1]; v.z -= o[2]; v.w -= o[3];
                }
                *reinterpret_cast<float4*>(zb + b * PANEL + c * LDZ + 4 * q) = v;
            }
            __syncthreads();
            solve_few_rows<T, NT, W, BACK>(zb + b * PANEL, LDZ, lk + b * TILE, LDA, dinv);
            for (int v = tid; v < T * W; v += NT) {
                const int cc = v % W;
                if (c0 + cc < k) at(out, m, v / W, cc) = zb[b * PANEL + cc * LDZ + v / W];
            }
        } else if (step > 0) {
            cluster_wait();
        }

        if (ua < u1) {
            // the units, with the panel rank 0 published in the phase before
            const int s = p - dir;
            if (is_row(s)) {
                const float* src = zb0 + (s & 1) * PANEL;
                for (int v = tid; v < W * T / 4; v += NT) {
                    const int o4 = v / (T / 4) * LDZ + 4 * (v % (T / 4));
                    *reinterpret_cast<float4*>(zl + o4) = *reinterpret_cast<const float4*>(src + o4);
                }
            }
            for (int buf = 0; ua < u1; buf ^= 1) {
                cp_async_wait<0>();
                __syncthreads();   // the unit's operands and the panel are in place
                const bool fwd_arrow = !BACK && (plan[ua] & 0xff) == kArrowUnit;
                float* dst = fwd_arrow ? nullptr
                                       : slots0 + ja.target % nslot * PANEL + c * LDZ + 4 * q;
                float old[4] = {0.f, 0.f, 0.f, 0.f};
                const bool mine = owner && (!fwd_arrow || c0 + c < k);
                if (mine && !ja.first) {   // read before the product, to hide its latency
                    if (fwd_arrow) {
#pragma unroll
                        for (int u = 0; u < 4; ++u) old[u] = at(acca, ja.target, 4 * q + u, c);
                    } else {
                        const float4 s4 = *reinterpret_cast<const float4*>(dst);
                        old[0] = s4.x; old[1] = s4.y; old[2] = s4.z; old[3] = s4.w;
                    }
                }
                float o[4];
                tile_times_panel<T, W, BACK>(o, ring + buf * UNIT,
                                             ja.z ? ring + buf * UNIT + TILE : zl);
                if (mine) {
                    if (fwd_arrow) {
#pragma unroll
                        for (int u = 0; u < 4; ++u) at(acca, ja.target, 4 * q + u, c) = old[u] + o[u];
                    } else {
                        *reinterpret_cast<float4*>(dst) =
                            make_float4(old[0] + o[0], old[1] + o[1], old[2] + o[2], old[3] + o[3]);
                    }
                }
                __syncthreads();   // buffer buf is free: the unit after next into it
                Job jx;
                const int ux = un < u1 ? next_job(p, un + 1, jx) : u1;
                if (ux < u1) stage_job(jx, buf);
                ua = un;
                ja = jn;
                un = ux;
                jn = jx;
            }
        }
        __syncthreads();
        cluster_arrive();
    }
    cluster_wait();
}

template <int T, int W, bool BACK>
cudaError_t launch_sweep(const float* dr, const float* r, const float* rhs, const float* xa,
                         float* out, float* acca, const int* plan, int cl, int batch, int ndt,
                         int bt, int nat, int k, int start, int lead, cudaStream_t s) {
    using S = SolveShape<T, W>;
    auto kernel = band_sweep_kernel<T, W, BACK>;
    // more than the card allows a block is refused by cudaFuncSetAttribute
    const size_t smem = sizeof(float) * (S::FIXED + static_cast<size_t>(lead + 1) * S::PANEL);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err == cudaSuccess && cl > kMaxCluster)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((k + W - 1) / W * cl, batch);
    cfg.blockDim = dim3(kSolveThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, dr, r, rhs, xa, out, acca, plan, ndt, bt, nat, k,
                              start, lead);
}

template <int T, bool BACK>
cudaError_t launch_width(int w, const float* dr, const float* r, const float* rhs,
                         const float* xa, float* out, float* acca, const int* plan, int cl,
                         int batch, int ndt, int bt, int nat, int k, int start, int lead,
                         cudaStream_t s) {
    switch (w) {
        case 1: return launch_sweep<T, 1, BACK>(dr, r, rhs, xa, out, acca, plan, cl, batch, ndt, bt, nat, k, start, lead, s);
        case 2: return launch_sweep<T, 2, BACK>(dr, r, rhs, xa, out, acca, plan, cl, batch, ndt, bt, nat, k, start, lead, s);
        case 4: return launch_sweep<T, 4, BACK>(dr, r, rhs, xa, out, acca, plan, cl, batch, ndt, bt, nat, k, start, lead, s);
        case 8: return launch_sweep<T, 8, BACK>(dr, r, rhs, xa, out, acca, plan, cl, batch, ndt, bt, nat, k, start, lead, s);
        default: return cudaErrorInvalidValue;
    }
}

template <bool BACK>
int sweep(const void* dr, const void* r, const void* rhs, const void* xa, void* out, void* acca,
          const void* plan, int cl, int w, int batch, int ndt, int bt, int nat, int t, int k,
          int start, int lead, void* stream) {
    if (cl < 1 || cl > kMaxClusterNonPortable || plan == nullptr || batch < 1 || batch > 65535 ||
        ndt < 1 || k < 1 || bt < 0 || nat < 0 || start < 0 || lead < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto* pd = static_cast<const float*>(dr);
    const auto* pr = static_cast<const float*>(r);
    const auto* pb = static_cast<const float*>(rhs);
    const auto* px = static_cast<const float*>(xa);
    auto* po = static_cast<float*>(out);
    auto* pa = static_cast<float*>(acca);
    const auto* pl = static_cast<const int*>(plan);
    auto s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (t) {
        case 8: err = launch_width<8, BACK>(w, pd, pr, pb, px, po, pa, pl, cl, batch, ndt, bt, nat, k, start, lead, s); break;
        case 16: err = launch_width<16, BACK>(w, pd, pr, pb, px, po, pa, pl, cl, batch, ndt, bt, nat, k, start, lead, s); break;
        case 32: err = launch_width<32, BACK>(w, pd, pr, pb, px, po, pa, pl, cl, batch, ndt, bt, nat, k, start, lead, s); break;
        case 64: err = launch_width<64, BACK>(w, pd, pr, pb, px, po, pa, pl, cl, batch, ndt, bt, nat, k, start, lead, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// How many clusters of cl blocks of the sweeps at tile size T the card holds
// at once with one block an SM: the occupancy of a launch that asks for all
// the shared memory a block may have.
template <int T>
cudaError_t max_active_clusters(int cl, int* out) {
    auto kernel = band_sweep_kernel<T, 1, true>;
    int dev = 0, smem = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess && cl > kMaxCluster)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cl);
    cfg.blockDim = dim3(kSolveThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
}

}  // namespace stiles

// How many clusters of `cluster` blocks of the sweeps at tile size t the
// card holds at once, one block an SM, into *out.
extern "C" int stiles_solve_max_active_clusters(int t, int cluster, void* out) {
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

// dr (ndt, bt+1, t, t), r (ndt, nat, t, t), bd (ndt, t, k) -> yd (ndt, t, k),
// acca (nat, t, k); ceil(k / width) clusters of `cluster` blocks on the plan
// table `plan` (device memory), slots for lead + 1 rows; for each of `batch`
// such problems, contiguous one after another, in the same launch.
extern "C" int stiles_band_forward_sweep_f32(const void* dr, const void* r, const void* bd,
                                             void* yd, void* acca, const void* plan,
                                             int cluster, int width, int batch, int ndt, int bt,
                                             int nat, int t, int k, int start, int lead,
                                             void* stream) {
    return stiles::sweep<false>(dr, r, bd, nullptr, yd, acca, plan, cluster, width, batch, ndt,
                                bt, nat, t, k, start, lead, stream);
}

// dr, r as above, yd (ndt, t, k), xa (nat, t, k) -> xd (ndt, t, k), batched alike.
extern "C" int stiles_band_backward_sweep_f32(const void* dr, const void* r, const void* yd,
                                              const void* xa, void* xd, const void* plan,
                                              int cluster, int width, int batch, int ndt, int bt,
                                              int nat, int t, int k, int start, int lead,
                                              void* stream) {
    return stiles::sweep<true>(dr, r, yd, xa, xd, nullptr, plan, cluster, width, batch, ndt, bt,
                               nat, t, k, start, lead, stream);
}
