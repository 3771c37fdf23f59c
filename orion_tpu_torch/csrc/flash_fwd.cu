// Kernel A, flash_fwd: causal flash-attention forward with an online
// softmax, for prefill; and kernel A', flash_chunk_fwd, its ring-chunk
// form over explicit kv positions (the same templates, KvPos = true).
//
// Replaces: orion_tpu/ops/pallas/flash_attention.py, _fwd (its kernel
// body _fwd_kernel), reached through flash_attention_gqa — the form
// without explicit kv positions (slot j holds absolute position j) —
// and, as A', _fwd with use_kvpos=True and clamp=False, reached through
// flash_chunk_fwd for ring attention (orion_tpu/parallel/longctx.py).
//
// Semantics: the query at absolute position p attends to kv slot j iff
// j <= p (A) or kvpos[b, j] <= p (A'); query head h reads kv head
// h / (H / Hkv) (GQA, no repeat_kv).  Running max, sum and accumulator
// are f32; O is written in the input type, LSE in f32.  A row with no
// valid key gives O = 0 and LSE ~ -1e30 (the neutral element of the
// ring's merge).  q, k, v and o are read and written through their
// [B, L, H, D] strides, head dim contiguous, so the caller makes no
// transposes.
//
// Bound on this card: the work is 4·D flops per valid (query, key)
// pair.  At the serving slice's prefill (B = 8, Lq = 512, Lk = 640,
// H = 8, D = 256, ragged frontiers) that is ~140 flops per byte of
// q/k/v/o, under the bf16 balance point (~295), so its least time is
// set by bytes; the ring slice's chunks (2,048 queries against 2,048
// keys, D = 256) do ~2,000 flops a byte and are set by operations.
//
// bf16: the Hopper body (flash_fwd_wgmma_kernel, sm_90a).  One block of
// two consumer warpgroups takes 128 query rows of one (head, batch);
// each warpgroup owns 64 rows, wgmma's M.  The q tile is staged once in
// shared memory; K/V tiles of 64 slots go through a ring of two stages
// filled by 16-byte cp.async copies (slots past Lk zero-filled through
// the src-size operand), so the next tile's load overlaps this tile's
// products; q, k and v therefore need 16-byte aligned bases and batch,
// sequence and head strides (the wrapper raises on others).  Every
// tile lies in shared memory in wgmma's 128-byte swizzled layout:
// 64-column chunks of 128-byte rows, the 16-byte unit u of row r
// stored at u ^ (r % 8).  S = Q·Kᵀ is wgmma m64n64k16 with
// both operands K-major in shared memory (D/16 k-steps).  The online
// softmax runs in registers: each thread holds two rows of S and takes
// their max across its quad with two shuffles; its share of the row
// sum is reduced once, at the end.  P is rounded to bf16 in registers
// and is wgmma's A operand from registers (the f32 S fragment is the
// bf16 A fragment, no shuffle), V the MN-major B operand (transposed
// read), N = D: O += P·V in 4 k-steps of m64nDk16, O in registers.
// Tile skipping: A's kv loop ends at the q tile's frontier
// max(qpos) + 1; A' reads each tile's position range once per block
// (kept in shared memory, 8 bytes a tile, so a launch refuses chunks
// whose ranges do not fit beside the tiles: Lk above ~270K slots at
// D = 256) and skips, unloaded, every tile whose smallest position
// exceeds the q tile's largest.  A warpgroup skips
// the products of a tile none of its rows sees, and applies the
// per-element mask only on tiles that straddle one of its rows'
// frontiers (largest key position above its smallest query position,
// or slots past Lk): fully visible tiles take no compares.  What bounds
// it: the two products run on the tensor cores, but each warpgroup
// waits for S before its softmax and for P·V before the next tile, and
// one barrier a tile joins the warpgroups, so no softmax overlaps a
// product (no producer warp, no ping-pong between warpgroups).
//
// f32: the CUDA-core body (flash_fwd_kernel), a fixed choice by dtype,
// not a fallback.  The tensor cores would round f32 inputs to tf32,
// and the f32 path is held to f32 accuracy (the card tests' 1e-4); no
// main path runs A or A' in f32 (serving, GRPO and long context compute
// in bf16).  It takes 16 query rows a block and 32 kv slots a tile,
// stages Q (pre-scaled) and K/V widened to f32 in shared memory, scores
// lane = slot, warp = 4 rows, and keeps its slice of the accumulator in
// registers.  A bf16 launch that fails to build or launch raises in
// the wrapper; it never reaches this body.

#include <climits>

#include "common.cuh"

namespace {

using namespace orion;  // the Hopper building blocks of common.cuh

struct FlashParams {
    const void* q;
    const void* k;
    const void* v;
    const int* qpos;
    const int* kvpos;  // A' only: [B, Lk] positions of the kv slots
    void* o;
    float* lse;
    int B, Lq, Lk, H, Hkv;
    long long sqb, sql, sqh, skb, skl, skh, svb, svl, svh, sob, sol, soh;
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
    return sizeof(float) * (size_t(BQ) * (D + 4) + size_t(BKV) * (D + 4) +
                            size_t(BKV) * D + size_t(BQ) * (BKV + 1) +
                            3 * BQ) +
           sizeof(int) * (BQ + BKV);
}
template <int D, bool KvPos>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(FlashParams p) {
    constexpr int DP = D + 4;                     // padded row stride
    constexpr int SP = BKV + 1;
    constexpr int CSPAN = D < NT ? D : NT;        // columns covered per pass
    constexpr int CPT = D / CSPAN;                // columns per thread
    constexpr int RPT = BQ / (NT / CSPAN);        // rows per thread

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* sQ = reinterpret_cast<float*>(smem_raw);
    float* sK = sQ + BQ * DP;
    float* sV = sK + BKV * DP;
    float* sS = sV + BKV * D;
    float* sM = sS + BQ * SP;
    float* sL = sM + BQ;
    float* sA = sL + BQ;
    int* sPos = reinterpret_cast<int*>(sA + BQ);
    int* sKvPos = sPos + BQ;  // A': positions of the current kv tile

    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hk = h / (p.H / p.Hkv);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    const float* qb = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
    const float* kb =
        static_cast<const float*>(p.k) + b * p.skb + hk * p.skh;
    const float* vb =
        static_cast<const float*>(p.v) + b * p.svb + hk * p.svh;

    if (tid < BQ) {
        const int i = q0 + tid;
        sPos[tid] = i < p.Lq ? p.qpos[(long long)b * p.Lq + i] : INT_MIN;
        sM[tid] = orion::kNegInf;
        sL[tid] = 0.f;
    }
    for (int e = tid; e < BQ * D; e += NT) {
        const int i = e / D, d = e % D;
        const int qi = q0 + i;
        sQ[i * DP + d] =
            qi < p.Lq ? qb[qi * p.sql + d] * p.scale : 0.f;
    }
    __syncthreads();

    int qmax = INT_MIN;
#pragma unroll
    for (int i = 0; i < BQ; ++i) qmax = max(qmax, sPos[i]);
    // Causal frontier: kv slots > qmax are masked for every row.  A'
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
            sV[j * D + d] = vv;
        }
        __syncthreads();

        // Scores: lane = kv slot, warp = 4 query rows.
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
            const float4 kk = *reinterpret_cast<const float4*>(&sK[lane * DP + d]);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const float4 qq =
                    *reinterpret_cast<const float4*>(&sQ[(warp * 4 + r) * DP + d]);
                s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
            }
        }
        const int kj = j0 + lane;
        const int kp = KvPos ? sKvPos[lane] : kj;  // the key's position
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int row = warp * 4 + r;
            const bool valid = kj < p.Lk && kp <= sPos[row];
            const float sv = valid ? s[r] : -INFINITY;
            const float m_old = sM[row];
            const float m_new = fmaxf(m_old, orion::warp_max(sv));
            const float pr = valid ? expf(s[r] - m_new) : 0.f;
            const float psum = orion::warp_sum(pr);
            sS[row * SP + lane] = pr;
            __syncwarp();
            if (lane == 0) {
                const float alpha = expf(m_old - m_new);
                sA[row] = alpha;
                sL[row] = sL[row] * alpha + psum;
                sM[row] = m_new;
            }
        }
        __syncthreads();

        // acc = acc * alpha + P @ V over this tile.
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            const float a = sA[r0 + r];
#pragma unroll
            for (int c = 0; c < CPT; ++c) acc[r][c] *= a;
        }
        const int jn = min(BKV, p.Lk - j0);
        for (int j = 0; j < jn; ++j) {
            float vv[CPT];
#pragma unroll
            for (int c = 0; c < CPT; ++c) vv[c] = sV[j * D + c0 + c * CSPAN];
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
                const float pr = sS[(r0 + r) * SP + j];
#pragma unroll
                for (int c = 0; c < CPT; ++c) acc[r][c] += pr * vv[c];
            }
        }
        __syncthreads();
    }

    float* ob = static_cast<float*>(p.o) + b * p.sob + h * p.soh;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        const int qi = q0 + r0 + r;
        if (qi >= p.Lq) continue;
        const float inv = 1.f / fmaxf(sL[r0 + r], 1e-30f);
#pragma unroll
        for (int c = 0; c < CPT; ++c)
            ob[qi * p.sol + c0 + c * CSPAN] = acc[r][c] * inv;
    }
    if (p.lse != nullptr && tid < BQ && q0 + tid < p.Lq) {
        p.lse[((long long)b * p.H + h) * p.Lq + q0 + tid] =
            sM[tid] + logf(fmaxf(sL[tid], 1e-30f));
    }
}

template <int D, bool KvPos>
int launch_f32(const FlashParams& p, cudaStream_t stream) {
    const size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D, KvPos>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((p.Lq + BQ - 1) / BQ, p.H, p.B);
    flash_fwd_kernel<D, KvPos><<<grid, NT, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// bf16: the Hopper body (wgmma, cp.async, 64-row warpgroup tiles).
// ---------------------------------------------------------------------

constexpr int WG_BM = 128;     // query rows per block: 2 warpgroups x 64
constexpr int WG_BN = 64;      // kv slots per tile
constexpr int WG_NT = 256;     // threads per block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of one block, in bytes from a 1024-byte aligned base
// (the 128-byte swizzle repeats every 8 rows of 128 bytes).  Q is
// [D/64 chunks][128 rows][128 B]; each K or V stage [D/64][64][128 B].
template <int D, bool KvPos>
struct WgSmem {
    static constexpr int kQ = WG_BM * D * 2;
    static constexpr int kKV = WG_BN * D * 2;            // one stage
    static constexpr int kOffK = kQ;                     // 2 stages
    static constexpr int kOffV = kOffK + 2 * kKV;        // 2 stages
    static constexpr int kOffKvPos = kOffV + 2 * kKV;    // int [2][BN]
    static constexpr int kOffQPos = kOffKvPos + 2 * WG_BN * 4;  // int [BM]
    static constexpr int kOffStat = kOffQPos + WG_BM * 4;  // int2 [ntiles]
    static constexpr int kBytes = 1024 + kOffStat;  // A': + 8 B a tile
};

template <int D, bool KvPos>
__global__ void __launch_bounds__(WG_NT, 1)
flash_fwd_wgmma_kernel(FlashParams p) {
    using Sm = WgSmem<D, KvPos>;
    constexpr int C16 = D / 8;  // 16-byte units in a row

    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023) & ~1023u;
    unsigned char* sm = smem_raw + (base - raw);
    const uint32_t sQ = base, sK = base + Sm::kOffK, sV = base + Sm::kOffV;
    int* sKvPos = reinterpret_cast<int*>(sm + Sm::kOffKvPos);
    int* sQPos = reinterpret_cast<int*>(sm + Sm::kOffQPos);
    int2* sStat = reinterpret_cast<int2*>(sm + Sm::kOffStat);

    const int q0 = blockIdx.x * WG_BM;
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
    const __nv_bfloat16* kb =
        static_cast<const __nv_bfloat16*>(p.k) + b * p.skb + hk * p.skh;
    const __nv_bfloat16* vb =
        static_cast<const __nv_bfloat16*>(p.v) + b * p.svb + hk * p.svh;
    const int* kvp = KvPos ? p.kvpos + (long long)b * p.Lk : nullptr;

    if (tid < WG_BM) {
        const int i = q0 + tid;
        sQPos[tid] = i < p.Lq ? p.qpos[(long long)b * p.Lq + i] : INT_MIN;
    }
    const int ntiles = (p.Lk + WG_BN - 1) / WG_BN;
    if constexpr (KvPos) {
        // Each tile's position range over its slots < Lk, one warp a
        // tile; a ragged tile's largest is INT_MAX (it needs the mask).
        for (int t = tid >> 5; t < ntiles; t += WG_NT / 32) {
            int lo = INT_MAX, hi = INT_MIN;
            for (int j = t * WG_BN + lane; j < (t + 1) * WG_BN; j += 32) {
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

    // Tile t's key positions: lo the smallest, hi the largest, or
    // INT_MAX when slots past Lk are in it.
    auto range = [&](int t, int& lo, int& hi) {
        if constexpr (KvPos) {
            const int2 s = sStat[t];
            lo = s.x;
            hi = s.y;
        } else {
            lo = t * WG_BN;
            hi = (t + 1) * WG_BN > p.Lk ? INT_MAX : (t + 1) * WG_BN - 1;
        }
    };
    // A: the causal frontier, kv slots > blk_max are masked for every
    // row.  A': every tile, the invisible ones skipped by next().
    const int nt = KvPos ? ntiles
                 : blk_max < 0 ? 0
                 : ((blk_max >= p.Lk ? p.Lk : blk_max + 1) + WG_BN - 1) /
                       WG_BN;
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
        const int j0 = t * WG_BN;
        for (int e = tid; e < WG_BN * C16; e += WG_NT) {
            const int r = e / C16, c = e % C16;
            const bool ok = j0 + r < p.Lk;
            const long long j = ok ? j0 + r : 0;
            const uint32_t off = st * Sm::kKV + swz(r, c, WG_BN);
            cp_async16(sK + off, kb + j * p.skl + c * 8, ok);
            cp_async16(sV + off, vb + j * p.svl + c * 8, ok);
        }
        if constexpr (KvPos) {
            if (tid < WG_BN) {
                const bool ok = j0 + tid < p.Lk;
                cp_async4(smem_u32(sKvPos + st * WG_BN + tid),
                          kvp + (ok ? j0 + tid : 0), ok);
            }
        }
    };

    float o[D / 2];  // this thread's part of the warpgroup's 64 x D O
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY;  // running max, log2 units
    float l_a = 0.f, l_b = 0.f;              // this thread's share of l
    const float sl2 = p.scale * kLog2e;

    int t = next(0);
    if (t < nt) {
        for (int e = tid; e < WG_BM * C16; e += WG_NT) {
            const int r = e / C16, c = e % C16;
            const bool ok = q0 + r < p.Lq;
            const long long i = ok ? q0 + r : 0;
            cp_async16(sQ + swz(r, c, WG_BM), qb + i * p.sql + c * 8, ok);
        }
        load_kv(t, 0);
    }
    cp_async_commit();
    for (int st = 0; t < nt; st ^= 1) {
        const int tn = next(t + 1);
        if (tn < nt) load_kv(tn, st ^ 1);
        cp_async_commit();
        cp_async_wait<1>();  // tile t (and Q) landed; tn may be in flight
        fence_proxy_async();
        __syncthreads();

        int lo, hi;
        range(t, lo, hi);
        if (wg_max != INT_MIN && lo <= wg_max) {
            // S = Q·Kᵀ for this warpgroup's 64 rows and the tile's 64
            // slots.  The thread holds s[4n + 2i + c]: row (i ? b : a),
            // column 8n + cb + c.
            float s[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) s[i] = 0.f;
            const uint32_t qw = sQ + wg * 64 * 128;
            const uint32_t kt = sK + st * Sm::kKV;
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < D / 16; ++k) {
                const uint32_t cq = (k >> 2) * (WG_BM * 128) + (k & 3) * 32;
                const uint32_t ck = (k >> 2) * (WG_BN * 128) + (k & 3) * 32;
                wgmma_ss_n64(s, wg_desc(qw + cq, 16, 1024),
                             wg_desc(kt + ck, 16, 1024), k > 0);
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_regs<32>(s);

#pragma unroll
            for (int i = 0; i < 32; ++i) s[i] *= sl2;
            if (hi > wg_min) {  // the tile straddles a row's frontier
                const int j0 = t * WG_BN;
#pragma unroll
                for (int n = 0; n < 8; ++n) {
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        const int col = 8 * n + cb + c;
                        const int j = j0 + col;
                        const int kp =
                            KvPos ? sKvPos[st * WG_BN + col] : j;
                        const bool in = j < p.Lk;
                        if (!(in && kp <= pos_a)) s[4 * n + c] = -INFINITY;
                        if (!(in && kp <= pos_b))
                            s[4 * n + 2 + c] = -INFINITY;
                    }
                }
            }

            float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                mx_a = fmaxf(mx_a, fmaxf(s[4 * n], s[4 * n + 1]));
                mx_b = fmaxf(mx_b, fmaxf(s[4 * n + 2], s[4 * n + 3]));
            }
#pragma unroll
            for (int x = 1; x <= 2; x <<= 1) {
                mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
                mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
            }
            const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
            // A row with no valid key so far keeps m = -inf; subtract 0
            // there so that exp2 gives 0, not NaN.
            const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
            const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
            const float al_a = exp2f(m_a - mu_a), al_b = exp2f(m_b - mu_b);
            m_a = mn_a;
            m_b = mn_b;

            // P in bf16, laid out as wgmma's A fragment: for k-step kk
            // (slots 16kk .. 16kk+15), pa[4kk .. 4kk+3].
            uint32_t pa[16];
            float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                const float p0 = exp2f(s[4 * n] - mu_a);
                const float p1 = exp2f(s[4 * n + 1] - mu_a);
                const float p2 = exp2f(s[4 * n + 2] - mu_b);
                const float p3 = exp2f(s[4 * n + 3] - mu_b);
                ps_a += p0 + p1;
                ps_b += p2 + p3;
                pa[2 * n] = pack_bf16(p0, p1);
                pa[2 * n + 1] = pack_bf16(p2, p3);
            }
            l_a = l_a * al_a + ps_a;
            l_b = l_b * al_b + ps_b;
#pragma unroll
            for (int n = 0; n < D / 8; ++n) {
                o[4 * n] *= al_a;
                o[4 * n + 1] *= al_a;
                o[4 * n + 2] *= al_b;
                o[4 * n + 3] *= al_b;
            }

            // O += P·V: V's slots are the reduction; rows of 128 bytes
            // hold 64 of its D columns (MN-major), 8 rows to a swizzle
            // atom (stride 1024 B), 64-column chunks 64 rows apart.
            const uint32_t vt = sV + st * Sm::kKV;
            fence_regs<D / 2>(o);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < WG_BN / 16; ++kk)
                wgmma_pv<D>(o, pa + 4 * kk,
                            wg_desc(vt + kk * 16 * 128, WG_BN * 128, 1024));
            wgmma_commit();
            wgmma_wait_all();
            fence_regs<D / 2>(o);
        }
        __syncthreads();  // stage st is free for the load of tile tn + 1
        t = tn;
    }

    // Epilogue: the row sums across each quad, then O = acc / l (0 on a
    // row with no valid key) and LSE = m + log l in natural units.
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, x);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, x);
    }
    __nv_bfloat16* ob =
        static_cast<__nv_bfloat16*>(p.o) + b * p.sob + h * p.soh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int qi = q0 + (i ? row_b : row_a);
        if (qi >= p.Lq) continue;
        const float l = i ? l_b : l_a;
        const float m = i ? m_b : m_a;
        const float inv = l > 0.f ? 1.f / l : 0.f;
        __nv_bfloat16* orow = ob + qi * p.sol + cb;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
                __floats2bfloat162_rn(o[4 * n + 2 * i] * inv,
                                      o[4 * n + 2 * i + 1] * inv);
        }
        if (p.lse != nullptr && (lane & 3) == 0) {
            p.lse[((long long)b * p.H + h) * p.Lq + qi] =
                l > 0.f ? (m + log2f(l)) * kLn2 : orion::kNegInf;
        }
    }
}

template <int D, bool KvPos>
int launch_wgmma(const FlashParams& p, cudaStream_t stream) {
    const int ntiles = (p.Lk + WG_BN - 1) / WG_BN;
    const int smem = WgSmem<D, KvPos>::kBytes + (KvPos ? ntiles * 8 : 0);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel<D, KvPos>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((p.Lq + WG_BM - 1) / WG_BM, p.H, p.B);
    flash_fwd_wgmma_kernel<D, KvPos><<<grid, WG_NT, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

template <bool KvPos>
int dispatch(int dtype, int D, const FlashParams& p, void* stream) {
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
extern "C" int orion_flash_fwd(
    const void* q, const void* k, const void* v, const int* qpos, void* o,
    float* lse, int B, int Lq, int Lk, int H, int Hkv, int D,
    long long sqb, long long sql, long long sqh,
    long long skb, long long skl, long long skh,
    long long svb, long long svl, long long svh,
    long long sob, long long sol, long long soh,
    float scale, int dtype, void* stream) {
    FlashParams p{q, k, v, qpos, nullptr, o, lse, B, Lq, Lk, H, Hkv,
                  sqb, sql, sqh, skb, skl, skh, svb, svl, svh,
                  sob, sol, soh, scale};
    return dispatch<false>(dtype, D, p, stream);
}

// Kernel A': as orion_flash_fwd, with the kv slots at positions
// kvpos [B, Lk] (int32, contiguous); lse is required.
extern "C" int orion_flash_chunk_fwd(
    const void* q, const void* k, const void* v, const int* qpos,
    const int* kvpos, void* o, float* lse, int B, int Lq, int Lk, int H,
    int Hkv, int D,
    long long sqb, long long sql, long long sqh,
    long long skb, long long skl, long long skh,
    long long svb, long long svl, long long svh,
    long long sob, long long sol, long long soh,
    float scale, int dtype, void* stream) {
    if (lse == nullptr) return (int)cudaErrorInvalidValue;
    FlashParams p{q, k, v, qpos, kvpos, o, lse, B, Lq, Lk, H, Hkv,
                  sqb, sql, sqh, skb, skl, skh, svb, svl, svh,
                  sob, sol, soh, scale};
    return dispatch<true>(dtype, D, p, stream);
}
