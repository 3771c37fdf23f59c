// Kernel B, flash_bwd_dq: the dQ half of the causal flash-attention
// backward, for training.
//
// Replaces: orion_tpu/ops/pallas/flash_attention.py, _dq_call (its
// kernel body _dq_kernel), reached through flash_attention_gqa's
// custom_vjp (_vjp_bwd -> _bwd_impl) — the form without explicit kv
// positions (slot j holds absolute position j).
//
// Semantics: with qs = q * scale, for each query row i of head h and
// each kv slot j <= q_position(i) of kv head h / (H / Hkv):
//   P  = exp(qs_i . k_j - LSE_i),   dP = dO_i . v_j,
//   dS = P * (dP - delta_i),        dQ_i = scale * sum_j dS_ij k_j,
// with LSE from the forward and delta = rowsum(dO * O).  Masked slots
// never reach the exp: a row with no valid key (LSE ~ -1e30) gives
// dQ = 0.  Sums in f32; dQ is written in the input type.
//
// Design.  The TPU kernel's sequential kv grid axis, with its dq
// scratch in VMEM, becomes a loop inside one block: one block per
// (q tile of 16 rows, head, batch), so every dQ row is summed by one
// block in a fixed order — no atomics, the result is the same from run
// to run.  The block reads its own q positions and loops over kv tiles
// of 32 slots only up to the tile's causal frontier, max(q_positions)
// + 1 (the Pallas kernel's _block_extents).  It reads the public
// [B, L, H, D] layout through strides.
//
// Bound on this card: 3 products of 2·D flops per valid (query, key)
// pair per head.  At the train shape (B = 8, L = 384, H = 8, D = 256,
// causal) that is ~7 GFLOP against ~63 MB of q, k, v, dO and dQ:
// ~115 flops per byte, under the bf16 balance point (~295), so the
// least time is set by bytes (~0.02 ms).  This first version does its
// products on the CUDA cores in f32 (no wgmma, no TMA), so it is
// limited by CUDA-core arithmetic far above that bound.  It keeps smem
// traffic low as kernel A does: q (pre-scaled) and dO are staged once
// per block, K and V rows are padded by 4 floats so a warp's 16-byte
// reads hit distinct banks, and each thread keeps its slice of the
// 16 x D dQ accumulator in registers.  A tensor-core version is later
// work.

#include <climits>

#include "common.cuh"

namespace {

constexpr int BQ = 16;   // query rows per block
constexpr int BKV = 32;  // kv slots per tile (one per lane)
constexpr int NT = 128;  // 4 warps; warp w scores rows 4w .. 4w+3

struct DqParams {
    const void* q;
    const void* k;
    const void* v;
    const void* dout;
    const int* qpos;
    const float* lse;
    const float* delta;
    void* dq;
    int B, Lq, Lk, H, Hkv;
    long long sqb, sql, sqh, skb, skl, skh, svb, svl, svh;
    long long sob, sol, soh, sgb, sgl, sgh;
    float scale;
};

template <int D>
constexpr size_t smem_bytes() {
    return sizeof(float) * (2 * size_t(BQ) * (D + 4) +
                            2 * size_t(BKV) * (D + 4) +
                            size_t(BQ) * (BKV + 1) + 2 * BQ) +
           sizeof(int) * BQ;
}

template <typename T, int D>
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

    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int hk = h / (p.H / p.Hkv);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    const T* qb = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
    const T* ob = static_cast<const T*>(p.dout) + b * p.sob + h * p.soh;
    const T* kb = static_cast<const T*>(p.k) + b * p.skb + hk * p.skh;
    const T* vb = static_cast<const T*>(p.v) + b * p.svb + hk * p.svh;

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
        sQ[i * DP + d] = in ? orion::to_f(qb[qi * p.sql + d]) * p.scale : 0.f;
        sO[i * DP + d] = in ? orion::to_f(ob[qi * p.sol + d]) : 0.f;
    }
    __syncthreads();

    int qmax = INT_MIN;
#pragma unroll
    for (int i = 0; i < BQ; ++i) qmax = max(qmax, sPos[i]);
    // Causal frontier: kv slots > qmax are masked for every row.
    const int kv_end = qmax < 0 ? 0 : min(p.Lk, qmax + 1);

    const int c0 = tid % CSPAN;
    const int r0 = (tid / CSPAN) * RPT;
    float acc[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

    for (int j0 = 0; j0 < kv_end; j0 += BKV) {
        for (int e = tid; e < BKV * D; e += NT) {
            const int j = e / D, d = e % D;
            const int kj = j0 + j;
            float kv = 0.f, vv = 0.f;
            if (kj < p.Lk) {
                kv = orion::to_f(kb[kj * p.skl + d]);
                vv = orion::to_f(vb[kj * p.svl + d]);
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
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int row = warp * 4 + r;
            const bool valid = kj < p.Lk && kj <= sPos[row];
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

    T* gb = static_cast<T*>(p.dq) + b * p.sgb + h * p.sgh;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        const int qi = q0 + r0 + r;
        if (qi >= p.Lq) continue;
#pragma unroll
        for (int c = 0; c < CPT; ++c)
            gb[qi * p.sgl + c0 + c * CSPAN] =
                orion::from_f<T>(acc[r][c] * p.scale);
    }
}

template <typename T, int D>
int launch(const DqParams& p, cudaStream_t stream) {
    const size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((p.Lq + BQ - 1) / BQ, p.H, p.B);
    flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const DqParams& p, cudaStream_t stream) {
    switch (D) {
        case 64: return launch<T, 64>(p, stream);
        case 128: return launch<T, 128>(p, stream);
        case 256: return launch<T, 256>(p, stream);
        default: return (int)cudaErrorInvalidValue;
    }
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
    DqParams p{q, k, v, dout, qpos, lse, delta, dq, B, Lq, Lk, H, Hkv,
               sqb, sql, sqh, skb, skl, skh, svb, svl, svh,
               sob, sol, soh, sgb, sgl, sgh, scale};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch_d<float>(D, p, s);
    if (dtype == 1) return dispatch_d<__nv_bfloat16>(D, p, s);
    return (int)cudaErrorInvalidValue;
}
