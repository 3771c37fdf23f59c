// Kernel C, flash_bwd_dkv: the dK/dV half of the causal flash-attention
// backward, for training; and kernel C', flash_chunk_bwd_dkv, its
// ring-chunk form over explicit kv positions (KvPos = true).
//
// Replaces: orion_tpu/ops/pallas/flash_attention.py, _dkv_call (its
// kernel body _dkv_kernel) together with the GQA group-sum that
// _bwd_impl does after it in XLA, reached through flash_attention_gqa's
// custom_vjp — the form without explicit kv positions (slot j holds
// absolute position j) — and, as C', the same with kv positions and
// clamp=False, reached through flash_chunk_grads for ring attention's
// backward.
//
// Semantics: with qs = q * scale, for each kv slot j of kv head g and
// every query row i of the n_rep query heads h of its group with
// j <= q_position(i):
//   P  = exp(qs_i . k_j - LSE_i),   dS = P * (dO_i . v_j - delta_i),
//   dV_j = sum_{h, i} P_ij dO_i,    dK_j = sum_{h, i} dS_ij qs_i,
// so dK carries the scale through qs.  Masked pairs never reach the
// exp (a row with no valid key, LSE ~ -1e30, adds nothing).  Sums in
// f32; dK and dV are written in the input type, [B, Lk, Hkv, D].
//
// Design.  The Pallas kernel runs one grid step per (q head, kv tile,
// q tile), carries dK/dV of one q head in VMEM scratch across the
// sequential q-tile axis, writes per-q-head [B, H, Lk, D] f32 and
// leaves the group-sum to XLA.  Here one block owns one (kv tile of
// 16 slots, kv head, batch) and loops over the n_rep query heads of
// the group and, for each, over the q tiles whose largest position
// reaches the tile's first slot (tiles wholly before it are skipped
// after reading their 16 positions).  Its dK and dV accumulators (two
// 16 x D f32 tiles, split over 256 threads: 32 registers each at
// D = 256) stay in registers across the whole group, so the group-sum
// happens in place and the [B, Lk, Hkv, D] outputs are written once,
// with no per-q-head buffer and no atomics — the result is the same
// from run to run.  K and V of the tile are staged once per block;
// each q tile's q (pre-scaled) and dO are staged once per visit.
//
// C' reads the key in slot j at position kvpos[b, j], in any order: the
// block loads its 16 positions once, and skips a q tile iff the tile's
// largest position is below their minimum (C skips it iff it is below
// the tile's first slot); each pair is masked by kvpos <= q position.
// LSE is the caller's GLOBAL log-sum-exp and delta comes from the final
// merged O, so dK and dV are complete for the chunk's keys.
//
// Bound on this card: 4 products of 2·D flops per valid (query, key)
// pair per head.  At the train shape (B = 8, L = 384, H = Hkv = 8,
// D = 256, causal) that is ~10 GFLOP against ~63 MB of q, k, v, dO,
// dK and dV: ~150 flops per byte, under the bf16 balance point
// (~295), so the least time is set by bytes (~0.02 ms).  This first
// version computes on the CUDA cores in f32 (no wgmma, no TMA), far
// above that bound.  A tensor-core version is later work.

#include <climits>

#include "common.cuh"

namespace {

constexpr int BQ = 16;   // query rows per step
constexpr int BKV = 16;  // kv slots per block
constexpr int NT = 256;  // the score pass gives each thread one (i, j)

static_assert(BQ * BKV == NT, "one (query, key) pair per thread");

struct DkvParams {
    const void* q;
    const void* k;
    const void* v;
    const void* dout;
    const int* qpos;
    const int* kvpos;  // C' only: [B, Lk] positions of the kv slots
    const float* lse;
    const float* delta;
    void* dk;
    void* dv;
    int B, Lq, Lk, H, Hkv;
    long long sqb, sql, sqh, skb, skl, skh, svb, svl, svh;
    long long sob, sol, soh, skgb, skgl, skgh, svgb, svgl, svgh;
    float scale;
};

template <int D>
constexpr size_t smem_bytes() {
    return sizeof(float) * (2 * size_t(BKV) * (D + 4) +
                            2 * size_t(BQ) * (D + 4) +
                            2 * size_t(BQ) * (BKV + 1) + 2 * BQ) +
           sizeof(int) * (BQ + BKV);
}

template <typename T, int D, bool KvPos>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(DkvParams p) {
    constexpr int DP = D + 4;                     // padded row stride
    constexpr int SP = BKV + 1;
    constexpr int CSPAN = D < NT ? D : NT;        // columns covered per pass
    constexpr int CPT = D / CSPAN;                // columns per thread
    constexpr int RPT = BKV / (NT / CSPAN);       // kv rows per thread

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* sK = reinterpret_cast<float*>(smem_raw);  // [BKV][DP]
    float* sV = sK + BKV * DP;                       // [BKV][DP]
    float* sQ = sV + BKV * DP;                       // [BQ][DP] q * scale
    float* sO = sQ + BQ * DP;                        // [BQ][DP] dO
    float* sP = sO + BQ * DP;                        // [BQ][SP] P
    float* sS = sP + BQ * SP;                        // [BQ][SP] dS
    float* sL = sS + BQ * SP;                        // [BQ] LSE
    float* sD = sL + BQ;                             // [BQ] delta
    int* sPos = reinterpret_cast<int*>(sD + BQ);
    int* sKvPos = sPos + BQ;  // C': positions of the block's kv slots

    const int j0 = blockIdx.x * BKV;
    const int hk = blockIdx.y;
    const int b = blockIdx.z;
    const int n_rep = p.H / p.Hkv;
    const int tid = threadIdx.x;

    const T* kb = static_cast<const T*>(p.k) + b * p.skb + hk * p.skh;
    const T* vb = static_cast<const T*>(p.v) + b * p.svb + hk * p.svh;
    for (int e = tid; e < BKV * D; e += NT) {
        const int j = e / D, d = e % D;
        const int kj = j0 + j;
        const bool in = kj < p.Lk;
        sK[j * DP + d] = in ? orion::to_f(kb[kj * p.skl + d]) : 0.f;
        sV[j * DP + d] = in ? orion::to_f(vb[kj * p.svl + d]) : 0.f;
    }
    // The smallest position among the block's keys: a q tile whose
    // largest position is below it has every pair masked.
    int kv_lo = j0;
    if constexpr (KvPos) {
        if (tid < BKV) {
            const int kj = j0 + tid;
            sKvPos[tid] = kj < p.Lk ? p.kvpos[(long long)b * p.Lk + kj]
                                    : INT_MAX;
        }
        __syncthreads();
        kv_lo = INT_MAX;
#pragma unroll
        for (int j = 0; j < BKV; ++j) kv_lo = min(kv_lo, sKvPos[j]);
    }

    // Score pass: thread -> pair (si, sj).  Update pass: thread -> kv
    // rows r0 .. r0+RPT-1, columns c0 + c * CSPAN.
    const int si = tid / BKV, sj = tid % BKV;
    const int c0 = tid % CSPAN;
    const int r0 = (tid / CSPAN) * RPT;
    float dk[RPT][CPT], dv[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) dk[r][c] = dv[r][c] = 0.f;

    for (int g = 0; g < n_rep; ++g) {
        const int h = hk * n_rep + g;
        const T* qb = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
        const T* ob = static_cast<const T*>(p.dout) + b * p.sob + h * p.soh;
        for (int q0 = 0; q0 < p.Lq; q0 += BQ) {
            __syncthreads();  // the previous step's readers are done
            if (tid < BQ) {
                const int i = q0 + tid;
                const long long row = ((long long)b * p.H + h) * p.Lq + i;
                sPos[tid] = i < p.Lq ? p.qpos[(long long)b * p.Lq + i]
                                     : INT_MIN;
                sL[tid] = i < p.Lq ? p.lse[row] : 0.f;
                sD[tid] = i < p.Lq ? p.delta[row] : 0.f;
            }
            __syncthreads();
            int qmax = INT_MIN;
#pragma unroll
            for (int i = 0; i < BQ; ++i) qmax = max(qmax, sPos[i]);
            if (qmax < kv_lo) continue;  // every pair masked (block-uniform)

            for (int e = tid; e < BQ * D; e += NT) {
                const int i = e / D, d = e % D;
                const int qi = q0 + i;
                const bool in = qi < p.Lq;
                sQ[i * DP + d] =
                    in ? orion::to_f(qb[qi * p.sql + d]) * p.scale : 0.f;
                sO[i * DP + d] = in ? orion::to_f(ob[qi * p.sol + d]) : 0.f;
            }
            __syncthreads();

            float s = 0.f, dp = 0.f;
#pragma unroll 4
            for (int d = 0; d < D; d += 4) {
                const float4 qq = *reinterpret_cast<const float4*>(&sQ[si * DP + d]);
                const float4 oo = *reinterpret_cast<const float4*>(&sO[si * DP + d]);
                const float4 kk = *reinterpret_cast<const float4*>(&sK[sj * DP + d]);
                const float4 vv = *reinterpret_cast<const float4*>(&sV[sj * DP + d]);
                s += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
                dp += oo.x * vv.x + oo.y * vv.y + oo.z * vv.z + oo.w * vv.w;
            }
            const int kj = j0 + sj;
            const int kp = KvPos ? sKvPos[sj] : kj;  // the key's position
            const bool valid = kj < p.Lk && kp <= sPos[si];
            const float pr = valid ? expf(s - sL[si]) : 0.f;
            sP[si * SP + sj] = pr;
            sS[si * SP + sj] = valid ? pr * (dp - sD[si]) : 0.f;
            __syncthreads();

            // dV += P^T dO, dK += dS^T qs over this q tile.
            for (int i = 0; i < BQ; ++i) {
                float o[CPT], qv[CPT];
#pragma unroll
                for (int c = 0; c < CPT; ++c) {
                    o[c] = sO[i * DP + c0 + c * CSPAN];
                    qv[c] = sQ[i * DP + c0 + c * CSPAN];
                }
#pragma unroll
                for (int r = 0; r < RPT; ++r) {
                    const float pv = sP[i * SP + r0 + r];
                    const float ds = sS[i * SP + r0 + r];
#pragma unroll
                    for (int c = 0; c < CPT; ++c) {
                        dv[r][c] += pv * o[c];
                        dk[r][c] += ds * qv[c];
                    }
                }
            }
        }
    }

    T* dkb = static_cast<T*>(p.dk) + b * p.skgb + hk * p.skgh;
    T* dvb = static_cast<T*>(p.dv) + b * p.svgb + hk * p.svgh;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        const int kj = j0 + r0 + r;
        if (kj >= p.Lk) continue;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
            dkb[kj * p.skgl + c0 + c * CSPAN] = orion::from_f<T>(dk[r][c]);
            dvb[kj * p.svgl + c0 + c * CSPAN] = orion::from_f<T>(dv[r][c]);
        }
    }
}

template <typename T, int D, bool KvPos>
int launch(const DkvParams& p, cudaStream_t stream) {
    const size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, D, KvPos>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((p.Lk + BKV - 1) / BKV, p.Hkv, p.B);
    flash_bwd_dkv_kernel<T, D, KvPos><<<grid, NT, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename T, bool KvPos>
int dispatch_d(int D, const DkvParams& p, cudaStream_t stream) {
    switch (D) {
        case 64: return launch<T, 64, KvPos>(p, stream);
        case 128: return launch<T, 128, KvPos>(p, stream);
        case 256: return launch<T, 256, KvPos>(p, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <bool KvPos>
int dispatch(int dtype, int D, const DkvParams& p, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch_d<float, KvPos>(D, p, s);
    if (dtype == 1) return dispatch_d<__nv_bfloat16, KvPos>(D, p, s);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int orion_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const int* qpos, const float* lse, const float* delta, void* dk,
    void* dv, int B, int Lq, int Lk, int H, int Hkv, int D,
    long long sqb, long long sql, long long sqh,
    long long skb, long long skl, long long skh,
    long long svb, long long svl, long long svh,
    long long sob, long long sol, long long soh,
    long long skgb, long long skgl, long long skgh,
    long long svgb, long long svgl, long long svgh,
    float scale, int dtype, void* stream) {
    DkvParams p{q, k, v, dout, qpos, nullptr, lse, delta, dk, dv, B, Lq, Lk,
                H, Hkv, sqb, sql, sqh, skb, skl, skh, svb, svl, svh,
                sob, sol, soh, skgb, skgl, skgh, svgb, svgl, svgh, scale};
    return dispatch<false>(dtype, D, p, stream);
}

// Kernel C': as orion_flash_bwd_dkv, with the kv slots at positions
// kvpos [B, Lk] (int32, contiguous) and lse the global LSE.
extern "C" int orion_flash_chunk_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const int* qpos, const int* kvpos, const float* lse, const float* delta,
    void* dk, void* dv, int B, int Lq, int Lk, int H, int Hkv, int D,
    long long sqb, long long sql, long long sqh,
    long long skb, long long skl, long long skh,
    long long svb, long long svl, long long svh,
    long long sob, long long sol, long long soh,
    long long skgb, long long skgl, long long skgh,
    long long svgb, long long svgl, long long svgh,
    float scale, int dtype, void* stream) {
    DkvParams p{q, k, v, dout, qpos, kvpos, lse, delta, dk, dv, B, Lq, Lk,
                H, Hkv, sqb, sql, sqh, skb, skl, skh, svb, svl, svh,
                sob, sol, soh, skgb, skgl, skgh, svgb, svgl, svgh, scale};
    return dispatch<true>(dtype, D, p, stream);
}
