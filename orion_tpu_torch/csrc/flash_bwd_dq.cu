// Kernel B, flash_bwd_dq: the dQ half of the causal flash-attention
// backward, for training; and kernel B', flash_chunk_bwd_dq, its
// ring-chunk form over explicit kv positions (KvPos = true).
//
// Replaces: orion_tpu/ops/pallas/flash_attention.py, _dq_call (its
// kernel body _dq_kernel), reached through flash_attention_gqa's
// custom_vjp (_vjp_bwd -> _bwd_impl) — the form without explicit kv
// positions (slot j holds absolute position j) — and, as B', _dq_call
// with kv positions and clamp=False, reached through flash_chunk_grads
// for ring attention's backward.
//
// Semantics: with qs = q * scale, for each query row i of head h and
// each kv slot j <= q_position(i) of kv head h / (H / Hkv):
//   P  = exp(qs_i . k_j - LSE_i),   dP = dO_i . v_j,
//   dS = P * (dP - delta_i),        dQ_i = scale * sum_j dS_ij k_j,
// with LSE from the forward and delta = rowsum(dO * O).  Masked slots
// never reach the exp: a row with no valid key (LSE ~ -1e30) gives
// dQ = 0.  Sums in f32; dQ is written in the input type.
//
// The TPU kernel's sequential kv grid axis, with its dq scratch in
// VMEM, becomes a loop inside one block: one block per (q tile, head,
// batch), so every dQ row is summed by one block in a fixed order — no
// atomics, the result is the same from run to run.  B loops over kv
// tiles only up to the q tile's causal frontier, max(q_positions) + 1
// (the Pallas kernel's _block_extents).  B' reads the key in slot j at
// position kvpos[b, j], in any order, and skips a kv tile (no K or V
// load) iff its smallest position exceeds the q tile's largest; LSE is
// the caller's GLOBAL log-sum-exp over every ring chunk and delta comes
// from the final merged O, so P = exp(s - LSE) is this chunk's exact
// share of the global attention and a masked pair adds exactly 0.
// Both read the public [B, L, H, D] layout through strides.
//
// Bound on this card: 3 products of 2·D flops per valid (query, key)
// pair per head.  At the train shape (B = 8, L = 384, H = 8, D = 256,
// causal) that is ~7 GFLOP against ~63 MB of q, k, v, dO and dQ:
// ~115 flops per byte, under the bf16 balance point (~295), so the
// least time is set by bytes (~0.02 ms); the ring chunks (2,048
// queries against 2,048 keys) are set by operations.
//
// bf16: the Hopper body (flash_bwd_dq_wgmma_kernel, sm_90a), the
// forward's design (flash_fwd.cu) with a second product pair.  One
// block of two warpgroups takes 128 query rows; each warpgroup owns 64
// rows, wgmma's M.  Q and dO are staged once in shared memory; K/V
// tiles of BN slots go through a ring of two stages filled by 16-byte
// cp.async copies (slots past Lk zero-filled), so the next tile's load
// overlaps this tile's products; q, k, v and dO therefore need 16-byte
// aligned bases and strides (the wrapper checks q, k and v, and copies
// an unaligned dO).  Every tile lies in wgmma's 128-byte swizzle.  Per
// kv tile and warpgroup, three products, all on the tensor cores:
//   S  = Q·Kᵀ   and  dP = dO·Vᵀ: wgmma m64nBNk16, both operands K-major
//                   in shared memory (D/16 k-steps), issued as one batch;
//   dQ += dS·K:     dS from registers as the A operand (the f32 S
//                   fragment is the bf16 A fragment, as P is in the
//                   forward), K's tile the MN-major B operand
//                   (transposed read), N = D, BN/16 k-steps; dQ stays in
//                   registers until the epilogue.  dS goes in as two
//                   bf16 halves, hi = bf16(dS) and lo = bf16(dS − hi),
//                   one product each: dS has both signs and the sum over
//                   slots cancels, so one rounding of dS to bf16 would
//                   leave dQ's error near twice the bf16 plain
//                   version's, and hi + lo keeps ~16 bits.
// P = exp2(s·scale·log2e − LSE·log2e) and dS = P·(dP − delta) are
// formed in registers.  P is set to 0 — by a select, before the
// product — for every masked pair and for every row whose LSE is
// <= -1e29 (no key in any chunk) or that lies past Lq, so no exp of a
// huge number is taken.  One dP leaves the tensor cores: in B, a row at
// position 0 sees slot 0 alone, where delta = dP exactly and dS is pure
// cancellation; that dP is summed in f64 on the CUDA cores.
// Tile skipping and masking follow the forward: a warpgroup skips the
// products of a tile none of its rows sees, and compares positions only
// on tiles that straddle one of its rows' frontiers or hold slots past
// Lk.  Blocks take q tiles from the last one down, so under a causal
// mask the longest ones start first.
//
// Shared memory sets the tile: Q and dO at 128 rows are 4·D·128 bytes
// (128 KB at D = 256), so at D = 256 two stages of 64-slot K/V tiles
// (128 KB more) would exceed a block's 227 KB; BN = 32 there (K/V 64
// KB, 194 KB a block) and BN = 64 at D = 64 and 128 (64 and 128 KB).
// It also keeps registers in bounds: the dQ accumulator is D/2 f32 a
// thread, S and dP BN/2 each, dS's halves BN/4 each.  What bounds it:
// the products wait on one another within a warpgroup (S and dP before
// dS, dS·K before the next tile) and one barrier a tile joins the
// warpgroups, so no exp overlaps a product (no producer warp, no
// ping-pong between warpgroups).
//
// f32: the CUDA-core body (flash_bwd_dq_kernel), a fixed choice by
// dtype, not a fallback — the tensor cores would round f32 to tf32 and
// the f32 path is held to f32 accuracy; no main path runs B or B' in
// f32.  One block per 16 query rows and 32-slot kv tiles: q
// (pre-scaled) and dO staged once per block, K and V rows padded by 4
// floats so a warp's 16-byte reads hit distinct banks, scores lane =
// slot, warp = 4 rows, each thread's slice of the 16 x D dQ accumulator
// in registers.

#include <climits>

#include "common.cuh"

namespace {

using namespace orion;  // the Hopper building blocks of common.cuh

struct DqParams {
    const void* q;
    const void* k;
    const void* v;
    const void* dout;
    const int* qpos;
    const int* kvpos;  // B' only: [B, Lk] positions of the kv slots
    const float* lse;
    const float* delta;
    void* dq;
    int B, Lq, Lk, H, Hkv;
    long long sqb, sql, sqh, skb, skl, skh, svb, svl, svh;
    long long sob, sol, soh, sgb, sgl, sgh;
    float scale;
};

// ---------------------------------------------------------------------
// f32: the CUDA-core body.
// ---------------------------------------------------------------------

constexpr int BQ = 16;   // query rows per block
constexpr int BKV = 32;  // kv slots per tile (one per lane)
constexpr int NT = 128;  // 4 warps; warp w scores rows 4w .. 4w+3

template <int D>
constexpr size_t smem_bytes() {
    return sizeof(float) * (2 * size_t(BQ) * (D + 4) +
                            2 * size_t(BKV) * (D + 4) +
                            size_t(BQ) * (BKV + 1) + 2 * BQ) +
           sizeof(int) * (BQ + BKV);
}

template <int D, bool KvPos>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(DqParams p) {
    constexpr int DP = D + 4;                     // padded row stride
    constexpr int SP = BKV + 1;
    constexpr int CSPAN = D < NT ? D : NT;        // columns covered per pass
    constexpr int CPT = D / CSPAN;                // columns per thread
    constexpr int RPT = BQ / (NT / CSPAN);        // rows per thread

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* sQ = reinterpret_cast<float*>(smem_raw);  // [BQ][DP] q * scale
    float* sO = sQ + BQ * DP;                        // [BQ][DP] dO
    float* sK = sO + BQ * DP;                        // [BKV][DP]
    float* sV = sK + BKV * DP;                       // [BKV][DP]
    float* sS = sV + BKV * DP;                       // [BQ][SP] dS
    float* sL = sS + BQ * SP;                        // [BQ] LSE
    float* sD = sL + BQ;                             // [BQ] delta
    int* sPos = reinterpret_cast<int*>(sD + BQ);
    int* sKvPos = sPos + BQ;  // B': positions of the current kv tile

    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hk = h / (p.H / p.Hkv);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    const float* qb = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
    const float* ob =
        static_cast<const float*>(p.dout) + b * p.sob + h * p.soh;
    const float* kb =
        static_cast<const float*>(p.k) + b * p.skb + hk * p.skh;
    const float* vb =
        static_cast<const float*>(p.v) + b * p.svb + hk * p.svh;

    if (tid < BQ) {
        const int i = q0 + tid;
        const long long row = ((long long)b * p.H + h) * p.Lq + i;
        sPos[tid] = i < p.Lq ? p.qpos[(long long)b * p.Lq + i] : INT_MIN;
        sL[tid] = i < p.Lq ? p.lse[row] : 0.f;
        sD[tid] = i < p.Lq ? p.delta[row] : 0.f;
    }
    for (int e = tid; e < BQ * D; e += NT) {
        const int i = e / D, d = e % D;
        const int qi = q0 + i;
        const bool in = qi < p.Lq;
        sQ[i * DP + d] = in ? qb[qi * p.sql + d] * p.scale : 0.f;
        sO[i * DP + d] = in ? ob[qi * p.sol + d] : 0.f;
    }
    __syncthreads();

    int qmax = INT_MIN;
#pragma unroll
    for (int i = 0; i < BQ; ++i) qmax = max(qmax, sPos[i]);
    // Causal frontier: kv slots > qmax are masked for every row.  B'
    // has none (its positions lie in any order) and tests each tile.
    const int kv_end = KvPos ? p.Lk : (qmax < 0 ? 0 : min(p.Lk, qmax + 1));

    const int c0 = tid % CSPAN;
    const int r0 = (tid / CSPAN) * RPT;
    float acc[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

    for (int j0 = 0; j0 < kv_end; j0 += BKV) {
        if constexpr (KvPos) {
            if (tid < BKV) {
                const int kj = j0 + tid;
                sKvPos[tid] = kj < p.Lk ? p.kvpos[(long long)b * p.Lk + kj]
                                        : INT_MAX;
            }
            __syncthreads();
            int kvmin = INT_MAX;
#pragma unroll
            for (int j = 0; j < BKV; ++j) kvmin = min(kvmin, sKvPos[j]);
            if (kvmin > qmax) {  // every pair masked (block-uniform)
                __syncthreads();  // sKvPos is read before it is rewritten
                continue;
            }
        }
        for (int e = tid; e < BKV * D; e += NT) {
            const int j = e / D, d = e % D;
            const int kj = j0 + j;
            float kv = 0.f, vv = 0.f;
            if (kj < p.Lk) {
                kv = kb[kj * p.skl + d];
                vv = vb[kj * p.svl + d];
            }
            sK[j * DP + d] = kv;
            sV[j * DP + d] = vv;
        }
        __syncthreads();

        // S = qs . k and dP = dO . v: lane = kv slot, warp = 4 rows.
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        float dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
            const float4 kk = *reinterpret_cast<const float4*>(&sK[lane * DP + d]);
            const float4 vv = *reinterpret_cast<const float4*>(&sV[lane * DP + d]);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int row = warp * 4 + r;
                const float4 qq = *reinterpret_cast<const float4*>(&sQ[row * DP + d]);
                const float4 oo = *reinterpret_cast<const float4*>(&sO[row * DP + d]);
                s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
                dp[r] += oo.x * vv.x + oo.y * vv.y + oo.z * vv.z + oo.w * vv.w;
            }
        }
        const int kj = j0 + lane;
        const int kp = KvPos ? sKvPos[lane] : kj;  // the key's position
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int row = warp * 4 + r;
            const bool valid = kj < p.Lk && kp <= sPos[row];
            sS[row * SP + lane] =
                valid ? expf(s[r] - sL[row]) * (dp[r] - sD[row]) : 0.f;
        }
        __syncthreads();

        // acc += dS @ K over this tile.
        const int jn = min(BKV, p.Lk - j0);
        for (int j = 0; j < jn; ++j) {
            float kv[CPT];
#pragma unroll
            for (int c = 0; c < CPT; ++c) kv[c] = sK[j * DP + c0 + c * CSPAN];
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
                const float ds = sS[(r0 + r) * SP + j];
#pragma unroll
                for (int c = 0; c < CPT; ++c) acc[r][c] += ds * kv[c];
            }
        }
        __syncthreads();
    }

    float* gb = static_cast<float*>(p.dq) + b * p.sgb + h * p.sgh;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        const int qi = q0 + r0 + r;
        if (qi >= p.Lq) continue;
#pragma unroll
        for (int c = 0; c < CPT; ++c)
            gb[qi * p.sgl + c0 + c * CSPAN] = acc[r][c] * p.scale;
    }
}

template <int D, bool KvPos>
int launch_f32(const DqParams& p, cudaStream_t stream) {
    const size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<D, KvPos>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((p.Lq + BQ - 1) / BQ, p.H, p.B);
    flash_bwd_dq_kernel<D, KvPos><<<grid, NT, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// bf16: the Hopper body (wgmma, cp.async, 64-row warpgroup tiles).
// ---------------------------------------------------------------------

constexpr int WG_BM = 128;     // query rows per block: 2 warpgroups x 64
constexpr int WG_NT = 256;     // threads per block
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one block, in bytes from a 1024-byte aligned base
// (the 128-byte swizzle repeats every 8 rows of 128 bytes).  Q and dO
// are each [D/64 chunks][128 rows][128 B]; each K or V stage
// [D/64][BN][128 B].
template <int D>
struct WgSmem {
    static constexpr int BN = D == 256 ? 32 : 64;        // kv slots a tile
    static constexpr int kQ = WG_BM * D * 2;
    static constexpr int kOffO = kQ;                     // dO
    static constexpr int kKV = BN * D * 2;               // one stage
    static constexpr int kOffK = 2 * kQ;                 // 2 stages
    static constexpr int kOffV = kOffK + 2 * kKV;        // 2 stages
    static constexpr int kOffKvPos = kOffV + 2 * kKV;    // int [2][BN]
    static constexpr int kOffQPos = kOffKvPos + 2 * BN * 4;  // int [BM]
    static constexpr int kOffStat = kOffQPos + WG_BM * 4;  // int2 [ntiles]
    static constexpr int kBytes = 1024 + kOffStat;  // B': + 8 B a tile
};

// x0, x1 as bf16 pairs hi = bf16(x) and lo = bf16(x - hi): hi + lo
// keeps ~16 bits of x where hi alone keeps 8.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// dO row r (of the block's 128) dotted with the V row of slot 0 in
// stage st, in f64, by the four lanes of a quad (each a quarter of the
// 16-byte units), reduced across the quad.
template <int D>
__device__ __forceinline__ double dot_slot0(const unsigned char* sm, int r,
                                            int st, int lane) {
    using Sm = WgSmem<D>;
    double acc = 0.0;
    for (int c = lane & 3; c < D / 8; c += 4) {
        const uint4 o = *reinterpret_cast<const uint4*>(
            sm + Sm::kOffO + swz(r, c, WG_BM));
        const uint4 v = *reinterpret_cast<const uint4*>(
            sm + Sm::kOffV + st * Sm::kKV + swz(0, c, Sm::BN));
        const uint32_t ow[4] = {o.x, o.y, o.z, o.w};
        const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
            const float2 of = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&ow[w]));
            const float2 vf = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&vw[w]));
            acc += double(of.x) * double(vf.x) + double(of.y) * double(vf.y);
        }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    return acc;
}

template <int D, bool KvPos>
__global__ void __launch_bounds__(WG_NT, 1)
flash_bwd_dq_wgmma_kernel(DqParams p) {
    using Sm = WgSmem<D>;
    constexpr int BN = Sm::BN;
    constexpr int C16 = D / 8;  // 16-byte units in a row

    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    unsigned char* sm = smem_raw + (base - raw);
    const uint32_t sQ = base, sO = base + Sm::kOffO;
    const uint32_t sK = base + Sm::kOffK, sV = base + Sm::kOffV;
    int* sKvPos = reinterpret_cast<int*>(sm + Sm::kOffKvPos);
    int* sQPos = reinterpret_cast<int*>(sm + Sm::kOffQPos);
    int2* sStat = reinterpret_cast<int2*>(sm + Sm::kOffStat);

    // Last q tile first: under a causal mask it has the most kv tiles.
    const int q0 = (gridDim.x - 1 - blockIdx.x) * WG_BM;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hk = h / (p.H / p.Hkv);
    const int tid = threadIdx.x;
    const int wg = tid >> 7;           // warpgroup: rows 64wg .. 64wg+63
    const int lane = tid & 31;
    const int cb = 2 * (lane & 3);     // first column of the thread's pairs
    // The thread's two rows of the warpgroup's accumulators.
    const int row_a = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
    const int row_b = row_a + 8;

    const __nv_bfloat16* qb =
        static_cast<const __nv_bfloat16*>(p.q) + b * p.sqb + h * p.sqh;
    const __nv_bfloat16* ob =
        static_cast<const __nv_bfloat16*>(p.dout) + b * p.sob + h * p.soh;
    const __nv_bfloat16* kb =
        static_cast<const __nv_bfloat16*>(p.k) + b * p.skb + hk * p.skh;
    const __nv_bfloat16* vb =
        static_cast<const __nv_bfloat16*>(p.v) + b * p.svb + hk * p.svh;
    const int* kvp = KvPos ? p.kvpos + (long long)b * p.Lk : nullptr;

    if (tid < WG_BM) {
        const int i = q0 + tid;
        sQPos[tid] = i < p.Lq ? p.qpos[(long long)b * p.Lq + i] : INT_MIN;
    }
    const int ntiles = (p.Lk + BN - 1) / BN;
    if constexpr (KvPos) {
        // Each tile's position range over its slots < Lk, one warp a
        // tile; a ragged tile's largest is INT_MAX (it needs the mask).
        for (int t = tid >> 5; t < ntiles; t += WG_NT / 32) {
            int lo = INT_MAX, hi = INT_MIN;
            for (int j = t * BN + lane; j < (t + 1) * BN; j += 32) {
                if (j < p.Lk) {
                    const int kp = kvp[j];
                    lo = min(lo, kp);
                    hi = max(hi, kp);
                } else {
                    hi = INT_MAX;
                }
            }
            lo = __reduce_min_sync(0xffffffffu, lo);
            hi = __reduce_max_sync(0xffffffffu, hi);
            if (lane == 0) sStat[t] = make_int2(lo, hi);
        }
    }
    __syncthreads();

    // Position extents over the rows < Lq: the block's largest, and
    // this warpgroup's smallest and largest.
    int blk_max = INT_MIN, wg_min = INT_MAX, wg_max = INT_MIN;
    for (int r = 0; r < WG_BM && q0 + r < p.Lq; ++r) {
        const int qp = sQPos[r];
        blk_max = max(blk_max, qp);
        if ((r >> 6) == wg) {
            wg_min = min(wg_min, qp);
            wg_max = max(wg_max, qp);
        }
    }
    const int pos_a = sQPos[row_a];
    const int pos_b = sQPos[row_b];
    // The rows' LSE (log2 units) and delta.  A row past Lq, or with no
    // key in any chunk (LSE ~ -1e30), is dead: its P is 0 everywhere.
    const int qi_a = q0 + row_a, qi_b = q0 + row_b;
    const long long stat0 = ((long long)b * p.H + h) * p.Lq;
    const float lse_a = qi_a < p.Lq ? p.lse[stat0 + qi_a] : orion::kNegInf;
    const float lse_b = qi_b < p.Lq ? p.lse[stat0 + qi_b] : orion::kNegInf;
    const float del_a = qi_a < p.Lq ? p.delta[stat0 + qi_a] : 0.f;
    const float del_b = qi_b < p.Lq ? p.delta[stat0 + qi_b] : 0.f;
    const bool live_a = lse_a > -1e29f, live_b = lse_b > -1e29f;
    const float l2_a = lse_a * kLog2e, l2_b = lse_b * kLog2e;

    // Tile t's key positions: lo the smallest, hi the largest, or
    // INT_MAX when slots past Lk are in it.
    auto range = [&](int t, int& lo, int& hi) {
        if constexpr (KvPos) {
            const int2 s = sStat[t];
            lo = s.x;
            hi = s.y;
        } else {
            lo = t * BN;
            hi = (t + 1) * BN > p.Lk ? INT_MAX : (t + 1) * BN - 1;
        }
    };
    // B: the causal frontier, kv slots > blk_max are masked for every
    // row.  B': every tile, the invisible ones skipped by next().
    const int nt = KvPos ? ntiles
                 : blk_max < 0 ? 0
                 : ((blk_max >= p.Lk ? p.Lk : blk_max + 1) + BN - 1) / BN;
    auto next = [&](int t) {
        if constexpr (KvPos) {
            for (; t < nt; ++t) {
                int lo, hi;
                range(t, lo, hi);
                if (lo <= blk_max) break;
            }
        }
        return t;
    };

    auto load_kv = [&](int t, int st) {
        const int j0 = t * BN;
        for (int e = tid; e < BN * C16; e += WG_NT) {
            const int r = e / C16, c = e % C16;
            const bool ok = j0 + r < p.Lk;
            const long long j = ok ? j0 + r : 0;
            const uint32_t off = st * Sm::kKV + swz(r, c, BN);
            cp_async16(sK + off, kb + j * p.skl + c * 8, ok);
            cp_async16(sV + off, vb + j * p.svl + c * 8, ok);
        }
        if constexpr (KvPos) {
            if (tid < BN) {
                const bool ok = j0 + tid < p.Lk;
                cp_async4(smem_u32(sKvPos + st * BN + tid),
                          kvp + (ok ? j0 + tid : 0), ok);
            }
        }
    };

    float dq[D / 2];  // this thread's part of the warpgroup's 64 x D dQ
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    const float sl2 = p.scale * kLog2e;

    int t = next(0);
    if (t < nt) {
        for (int e = tid; e < WG_BM * C16; e += WG_NT) {
            const int r = e / C16, c = e % C16;
            const bool ok = q0 + r < p.Lq;
            const long long i = ok ? q0 + r : 0;
            const uint32_t off = swz(r, c, WG_BM);
            cp_async16(sQ + off, qb + i * p.sql + c * 8, ok);
            cp_async16(sO + off, ob + i * p.sol + c * 8, ok);
        }
        load_kv(t, 0);
    }
    cp_async_commit();
    for (int st = 0; t < nt; st ^= 1) {
        const int tn = next(t + 1);
        if (tn < nt) load_kv(tn, st ^ 1);
        cp_async_commit();
        cp_async_wait<1>();  // tile t (and Q, dO) landed; tn may be in flight
        fence_proxy_async();
        __syncthreads();

        int lo, hi;
        range(t, lo, hi);
        if (wg_max != INT_MIN && lo <= wg_max) {
            // S = Q·Kᵀ and dP = dO·Vᵀ for this warpgroup's 64 rows and
            // the tile's BN slots, one batch.  The thread holds
            // s[4n + 2i + c]: row (i ? b : a), column 8n + cb + c.
            float s[BN / 2], dp[BN / 2];
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
            const uint32_t qw = sQ + wg * 64 * 128;
            const uint32_t ow = sO + wg * 64 * 128;
            const uint32_t kt = sK + st * Sm::kKV;
            const uint32_t vt = sV + st * Sm::kKV;
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < D / 16; ++k) {
                const uint32_t cq = (k >> 2) * (WG_BM * 128) + (k & 3) * 32;
                const uint32_t ck = (k >> 2) * (BN * 128) + (k & 3) * 32;
                wgmma_ss<BN>(s, wg_desc(qw + cq, 16, 1024),
                             wg_desc(kt + ck, 16, 1024), k > 0);
            }
#pragma unroll
            for (int k = 0; k < D / 16; ++k) {
                const uint32_t cq = (k >> 2) * (WG_BM * 128) + (k & 3) * 32;
                const uint32_t ck = (k >> 2) * (BN * 128) + (k & 3) * 32;
                wgmma_ss<BN>(dp, wg_desc(ow + cq, 16, 1024),
                             wg_desc(vt + ck, 16, 1024), k > 0);
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_regs<BN / 2>(s);
            fence_regs<BN / 2>(dp);

            if constexpr (!KvPos) {
                // A row at position 0 sees one key, slot 0: P = 1 and
                // delta = dP in exact arithmetic, so dS = P·(dP − delta)
                // is pure cancellation.  The tensor cores' truncating sum
                // would leave dP's last bits there; this dP is summed in
                // f64 instead, where the bf16 products are exact.
                if (t == 0 && __any_sync(0xffffffffu,
                                         pos_a == 0 || pos_b == 0)) {
                    const double ea = dot_slot0<D>(sm, row_a, st, lane);
                    const double eb = dot_slot0<D>(sm, row_b, st, lane);
                    if (cb == 0 && pos_a == 0) dp[0] = float(ea);
                    if (cb == 0 && pos_b == 0) dp[2] = float(eb);
                }
            }

            // P and dS = P·(dP − delta) in f32; P is 0 on masked pairs
            // and dead rows.  dS as bf16 pairs hi + lo, laid out as
            // wgmma's A fragment: for k-step kk (slots 16kk .. 16kk+15),
            // dh[4kk .. 4kk+3] and dl[4kk .. 4kk+3].
            const bool mask = hi > wg_min;  // the tile straddles a frontier
            const int j0 = t * BN;
            uint32_t dh[BN / 4], dl[BN / 4];
#pragma unroll
            for (int n = 0; n < BN / 8; ++n) {
                float ds[4];
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const int col = 8 * n + cb + c;
                    const int j = j0 + col;
                    const int kp = KvPos ? sKvPos[st * BN + col] : j;
                    const bool in = !mask || j < p.Lk;
                    const bool see_a =
                        live_a && in && (!mask || kp <= pos_a);
                    const bool see_b =
                        live_b && in && (!mask || kp <= pos_b);
                    const float pa =
                        see_a ? exp2f(fmaf(s[4 * n + c], sl2, -l2_a)) : 0.f;
                    const float pb = see_b
                        ? exp2f(fmaf(s[4 * n + 2 + c], sl2, -l2_b)) : 0.f;
                    ds[c] = pa * (dp[4 * n + c] - del_a);
                    ds[2 + c] = pb * (dp[4 * n + 2 + c] - del_b);
                }
                split_bf16(ds[0], ds[1], dh[2 * n], dl[2 * n]);
                split_bf16(ds[2], ds[3], dh[2 * n + 1], dl[2 * n + 1]);
            }

            // dQ += dS·K, hi then lo: K's slots are the reduction; rows of
            // 128 bytes hold 64 of its D columns (MN-major), 8 rows to a
            // swizzle atom (stride 1024 B), 64-column chunks BN rows
            // apart.
            fence_regs<D / 2>(dq);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BN / 16; ++kk) {
                const uint64_t dk =
                    wg_desc(kt + kk * 16 * 128, BN * 128, 1024);
                wgmma_pv<D>(dq, dh + 4 * kk, dk);
                wgmma_pv<D>(dq, dl + 4 * kk, dk);
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_regs<D / 2>(dq);
        }
        __syncthreads();  // stage st is free for the load of tile tn + 1
        t = tn;
    }

    // Epilogue: dQ = scale · acc in bf16 (0 on a row that saw no key).
    __nv_bfloat16* gb =
        static_cast<__nv_bfloat16*>(p.dq) + b * p.sgb + h * p.sgh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int qi = i ? qi_b : qi_a;
        if (qi >= p.Lq) continue;
        __nv_bfloat16* grow = gb + qi * p.sgl + cb;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
            *reinterpret_cast<__nv_bfloat162*>(grow + 8 * n) =
                __floats2bfloat162_rn(dq[4 * n + 2 * i] * p.scale,
                                      dq[4 * n + 2 * i + 1] * p.scale);
        }
    }
}

template <int D, bool KvPos>
int launch_wgmma(const DqParams& p, cudaStream_t stream) {
    const int ntiles = (p.Lk + WgSmem<D>::BN - 1) / WgSmem<D>::BN;
    const int smem = WgSmem<D>::kBytes + (KvPos ? ntiles * 8 : 0);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_wgmma_kernel<D, KvPos>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((p.Lq + WG_BM - 1) / WG_BM, p.H, p.B);
    flash_bwd_dq_wgmma_kernel<D, KvPos><<<grid, WG_NT, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

template <bool KvPos>
int dispatch(int dtype, int D, const DqParams& p, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {  // f32: the CUDA-core body
        switch (D) {
            case 64: return launch_f32<64, KvPos>(p, s);
            case 128: return launch_f32<128, KvPos>(p, s);
            case 256: return launch_f32<256, KvPos>(p, s);
        }
    } else if (dtype == 1) {  // bf16: wgmma; the wrapper checks alignment
        switch (D) {
            case 64: return launch_wgmma<64, KvPos>(p, s);
            case 128: return launch_wgmma<128, KvPos>(p, s);
            case 256: return launch_wgmma<256, KvPos>(p, s);
        }
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int orion_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const int* qpos, const float* lse, const float* delta, void* dq,
    int B, int Lq, int Lk, int H, int Hkv, int D,
    long long sqb, long long sql, long long sqh,
    long long skb, long long skl, long long skh,
    long long svb, long long svl, long long svh,
    long long sob, long long sol, long long soh,
    long long sgb, long long sgl, long long sgh,
    float scale, int dtype, void* stream) {
    DqParams p{q, k, v, dout, qpos, nullptr, lse, delta, dq, B, Lq, Lk, H,
               Hkv, sqb, sql, sqh, skb, skl, skh, svb, svl, svh,
               sob, sol, soh, sgb, sgl, sgh, scale};
    return dispatch<false>(dtype, D, p, stream);
}

// Kernel B': as orion_flash_bwd_dq, with the kv slots at positions
// kvpos [B, Lk] (int32, contiguous) and lse the global LSE.
extern "C" int orion_flash_chunk_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const int* qpos, const int* kvpos, const float* lse, const float* delta,
    void* dq, int B, int Lq, int Lk, int H, int Hkv, int D,
    long long sqb, long long sql, long long sqh,
    long long skb, long long skl, long long skh,
    long long svb, long long svl, long long svh,
    long long sob, long long sol, long long soh,
    long long sgb, long long sgl, long long sgh,
    float scale, int dtype, void* stream) {
    DqParams p{q, k, v, dout, qpos, kvpos, lse, delta, dq, B, Lq, Lk, H,
               Hkv, sqb, sql, sqh, skb, skl, skh, svb, svl, svh,
               sob, sol, soh, sgb, sgl, sgh, scale};
    return dispatch<true>(dtype, D, p, stream);
}
