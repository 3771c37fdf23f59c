// Kernel A, flash_fwd: causal flash-attention forward with an online
// softmax, for prefill; and kernel A', flash_chunk_fwd, its ring-chunk
// form over explicit kv positions (the same template, KvPos = true).
//
// Replaces: orion_tpu/ops/pallas/flash_attention.py, _fwd (its kernel
// body _fwd_kernel), reached through flash_attention_gqa — the form
// without explicit kv positions (slot j holds absolute position j) —
// and, as A', _fwd with use_kvpos=True and clamp=False, reached through
// flash_chunk_fwd for ring attention (orion_tpu/parallel/longctx.py).
//
// Semantics: the query at absolute position p attends to kv slot j iff
// j <= p; query head h reads kv head h / (H / Hkv) (GQA, no repeat_kv).
// Running max, sum and accumulator are f32; O is written in the input
// type, LSE in f32.  A row with no valid key gives O = 0 and
// LSE ~ -1e30, as the Pallas kernel does.
//
// Design.  The TPU kernel's sequential kv grid dimension, with its VMEM
// scratch carried across grid steps, becomes a loop inside one block:
// one block per (q tile of 16 rows, head, batch).  The block reads its
// own q positions (the TPU kernel's scalar-prefetched _block_extents)
// and loops over kv tiles of 32 slots only up to the tile's causal
// frontier, max(q_positions) + 1: tiles past it are never loaded (on a
// prefill over a gathered page table most of Lk lies past every row's
// position).  It reads the public [B, L, H, D] layout through strides,
// so the caller makes no transpose copies.
//
// A' reads the key in slot j at position kvpos[b, j], which may lie
// in any order (rotated zigzag chunks), so no frontier bounds the loop:
// the block visits every kv tile, loads its 32 positions first and
// skips the tile, without loading K or V, iff its smallest position
// exceeds the q tile's largest (the Pallas kernel's kvmin > qmax test).
// Each element is masked by kvpos <= q position.  A row with no valid
// key in the chunk keeps m = -1e30 and l = 0 and ends with O = 0 and
// LSE ~ -1e30, the neutral element of the ring's merge.  At the ring
// slice's chunks (B = 4 shards, 2,048 queries against 2,048 keys,
// D = 256) a chunk does ~2,000 flops per byte it must move, so its
// least time is set by operations, not bytes.
//
// Bound on this card: the work is 4·D flops per valid (query, key)
// pair.  At the slice's prefill shapes (B = 8, Lq = 512, Lk = 640,
// H = 8, D = 256, ragged frontiers) that is ~140 flops per byte of
// q/k/v/o, under the card's ~295 bf16 balance point, so the least time
// is set by bytes (~0.02 ms); longer prompts cross into operations.
// This first version does its products on the CUDA cores in f32 (no
// wgmma, no TMA, no pipelining), so it is limited by CUDA-core
// arithmetic far above either bound; it keeps smem traffic low
// instead: Q is staged once per block pre-scaled, K rows are padded so
// a warp's 16-byte reads hit distinct banks, and each thread keeps its
// slice of the 16 x D accumulator in registers.  A tensor-core (wgmma)
// version is later work.

#include <climits>

#include "common.cuh"

namespace {

constexpr int BQ = 16;   // query rows per block
constexpr int BKV = 32;  // kv slots per tile (one per lane)
constexpr int NT = 128;  // 4 warps; warp w scores rows 4w .. 4w+3

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

template <int D>
constexpr size_t smem_bytes() {
    return sizeof(float) * (size_t(BQ) * (D + 4) + size_t(BKV) * (D + 4) +
                            size_t(BKV) * D + size_t(BQ) * (BKV + 1) +
                            3 * BQ) +
           sizeof(int) * (BQ + BKV);
}

template <typename T, int D, bool KvPos>
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

    const T* qb = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
    const T* kb = static_cast<const T*>(p.k) + b * p.skb + hk * p.skh;
    const T* vb = static_cast<const T*>(p.v) + b * p.svb + hk * p.svh;

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
            qi < p.Lq ? orion::to_f(qb[qi * p.sql + d]) * p.scale : 0.f;
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
                kv = orion::to_f(kb[kj * p.skl + d]);
                vv = orion::to_f(vb[kj * p.svl + d]);
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

    T* ob = static_cast<T*>(p.o) + b * p.sob + h * p.soh;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
        const int qi = q0 + r0 + r;
        if (qi >= p.Lq) continue;
        const float inv = 1.f / fmaxf(sL[r0 + r], 1e-30f);
#pragma unroll
        for (int c = 0; c < CPT; ++c)
            ob[qi * p.sol + c0 + c * CSPAN] = orion::from_f<T>(acc[r][c] * inv);
    }
    if (p.lse != nullptr && tid < BQ && q0 + tid < p.Lq) {
        p.lse[((long long)b * p.H + h) * p.Lq + q0 + tid] =
            sM[tid] + logf(fmaxf(sL[tid], 1e-30f));
    }
}

template <typename T, int D, bool KvPos>
int launch(const FlashParams& p, cudaStream_t stream) {
    const size_t smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D, KvPos>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((p.Lq + BQ - 1) / BQ, p.H, p.B);
    flash_fwd_kernel<T, D, KvPos><<<grid, NT, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename T, bool KvPos>
int dispatch_d(int D, const FlashParams& p, cudaStream_t stream) {
    switch (D) {
        case 64: return launch<T, 64, KvPos>(p, stream);
        case 128: return launch<T, 128, KvPos>(p, stream);
        case 256: return launch<T, 256, KvPos>(p, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <bool KvPos>
int dispatch(int dtype, int D, const FlashParams& p, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch_d<float, KvPos>(D, p, s);
    if (dtype == 1) return dispatch_d<__nv_bfloat16, KvPos>(D, p, s);
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
