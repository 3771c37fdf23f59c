// Kernels D and D', paged_decode: one decode step of attention over the
// paged KV pool, through per-sequence block tables.
//
// Replaces: orion_tpu/ops/pallas/paged_attention.py,
// paged_decode_attention (kernel body _decode_kernel) — D with bf16/f32
// pools (quantized=False), D' with int8 pools and f32 per-slot scales
// (quantized=True, reached through paged_decode_attention_int8).  As in
// the reference, one kernel serves both pool types: the compile-time
// Quantized parameter picks the pool element type and the scale steps.
//
// Semantics: q [B, H, D] (one token per sequence); pools
// [N, Hkv, ps, D]; block_tables [B, max_pages] int32 (entry j = the
// pool page holding positions [j*ps, (j+1)*ps)); seq_lens [B] int32,
// the number of valid tokens including the current one.  Online
// softmax in f32 across pages, slots idx >= seq_len masked inside the
// last page, output [B, H, D] in q's type.  D' (scale pools
// [N, Hkv, 1, ps], so slot s of page P, kv head h has its scale at
// (P * Hkv + h) * ps + s), in the reference's order: s = (q * scale) .
// f32(K) times k_scale[slot] before the running max; the normaliser l
// sums the UNSCALED p = exp(s - m); then p *= v_scale[slot] and
// acc += p . f32(V).
//
// Design.  The TPU kernel's grid (batch, q-head, page) with scratch
// carried across the sequential page axis becomes one block per
// (kv head, sequence) that loops over its own ceil(seq_len / ps) pages,
// reading block_tables[b, j] itself (the TPU kernel's scalar
// prefetch).  The block serves all H / Hkv query heads of its kv head,
// so every page is read from device memory once, not once per query
// head; table entries past the last page in use are never read.
// Masked slots are never computed (the page loop stops at seq_len), so
// they never reach the exp.  D' reads its int8 rows with vector loads:
// 16 bytes a thread for K (D / 16 threads per row, the dot reduced
// over those lanes) and 8 bytes for V (8 output columns a thread).
//
// Bound on this card: bytes.  A step reads every valid K and V row
// once (2 * seq_len * Hkv * D elements per sequence: 2 bytes each in
// bf16, 1 in int8 plus 4 bytes of scale per slot and kv head for each
// of K and V) and does only ~4 * D * H / Hkv flops per row, far below
// the card's ~295 flop-per-byte balance point.  This first version
// loads pages with plain coalesced loads, one page at a time per
// block, so it is latency-bound below the bandwidth bound; overlapping
// page loads (cp.async or TMA double buffering) is later work.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NT = 128;       // 4 warps
constexpr int NWARP = NT / 32;
constexpr int MAX_REP = 8;    // query heads per kv head

struct DecodeParams {
    const void* q;
    const void* kp;
    const void* vp;
    const float* ks;          // D': scale pools [N, Hkv, 1, ps]; else null
    const float* vs;
    const int* bt;
    const int* lens;
    void* o;
    int B, H, Hkv, ps, max_pages;
    long long sqb, sqh, sob, soh;
    float scale;
};

// The P @ V split of a block's threads.  D: each thread takes CPT
// columns strided by CSPAN, SPLIT token-parallel groups.  D': each
// thread takes 8 adjacent columns (one 8-byte int8 load a row), D / 8
// threads a row, NT / (D / 8) token-parallel groups.
template <int D, bool Quantized>
struct PVSplit {
    static constexpr int CSPAN = D < NT ? D : NT;
    static constexpr int NACC = Quantized ? 8 : D / CSPAN;  // cols/thread
    static constexpr int TPR = Quantized ? D / 8 : CSPAN;   // threads/row
    static constexpr int SPLIT = NT / TPR;
    static constexpr int CSTRIDE = Quantized ? 1 : CSPAN;
    static __device__ __forceinline__ int col0(int tid) {
        return Quantized ? (tid % TPR) * 8 : tid % TPR;
    }
};

template <int D, bool Quantized>
size_t smem_bytes(int nrep, int ps) {
    using S = PVSplit<D, Quantized>;
    return sizeof(float) * (size_t(nrep) * D + size_t(nrep) * ps + 3 * nrep +
                            size_t(S::SPLIT) * nrep * D);
}

// 4 packed int8 -> float.
__device__ __forceinline__ void unpack4(int w, float* out) {
#pragma unroll
    for (int b = 0; b < 4; ++b)
        out[b] = static_cast<float>(static_cast<signed char>(w >> (8 * b)));
}

template <typename T, int D, bool Quantized>
__global__ void __launch_bounds__(NT) paged_decode_kernel(DecodeParams p) {
    using PT = typename std::conditional<Quantized, signed char, T>::type;
    using S = PVSplit<D, Quantized>;
    constexpr int VEC = D / 32;               // D: K elements per lane

    const int hk = blockIdx.x;
    const int b = blockIdx.y;
    const int nrep = p.H / p.Hkv;
    const int h0 = hk * nrep;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int ps = p.ps;

    extern __shared__ __align__(16) unsigned char smem_raw[];
    float* sQ = reinterpret_cast<float*>(smem_raw);   // [nrep][D]
    float* sS = sQ + nrep * D;                         // [nrep][ps]
    float* sM = sS + nrep * ps;
    float* sL = sM + nrep;
    float* sA = sL + nrep;
    float* sR = sA + nrep;                             // [SPLIT][nrep][D]

    const T* qb = static_cast<const T*>(p.q) + b * p.sqb;
    for (int e = tid; e < nrep * D; e += NT) {
        const int r = e / D, d = e % D;
        sQ[e] = orion::to_f(qb[(h0 + r) * p.sqh + d]) * p.scale;
    }
    if (tid < nrep) {
        sM[tid] = orion::kNegInf;
        sL[tid] = 0.f;
    }
    __syncthreads();

    const int seq_len = p.lens[b];
    // A length past the table's end reads only the table's pages (the
    // TPU kernel's grid stops at max_pages too), never past its row.
    const int npages = seq_len > 0 ? min((seq_len + ps - 1) / ps, p.max_pages)
                                   : 0;
    const int c0 = S::col0(tid);
    const int g = tid / S::TPR;
    float acc[MAX_REP][S::NACC];
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r)
#pragma unroll
        for (int c = 0; c < S::NACC; ++c) acc[r][c] = 0.f;

    const long long head_elems = (long long)ps * D;
    for (int pg = 0; pg < npages; ++pg) {
        const long long page = p.bt[(long long)b * p.max_pages + pg];
        const int n = min(ps, seq_len - pg * ps);
        const long long ph = page * p.Hkv + hk;
        const PT* kpage = static_cast<const PT*>(p.kp) + ph * head_elems;
        const PT* vpage = static_cast<const PT*>(p.vp) + ph * head_elems;

        if constexpr (Quantized) {
            // Scores: D / 16 lanes a row, 16 int8 each (one 16-byte
            // load); a warp takes 32 / (D / 16) rows at a time.
            constexpr int KT = D / 16;
            constexpr int RPW = 32 / KT;
            const int sub = lane % KT;
            const int rw = lane / KT;
            const float* kscale = p.ks + ph * ps;
            for (int j0 = warp * RPW; j0 < n; j0 += NWARP * RPW) {
                const int j = j0 + rw;
                float kf[16];
                if (j < n) {
                    const int4 raw = *reinterpret_cast<const int4*>(
                        kpage + (long long)j * D + sub * 16);
                    unpack4(raw.x, kf);
                    unpack4(raw.y, kf + 4);
                    unpack4(raw.z, kf + 8);
                    unpack4(raw.w, kf + 12);
                } else {
#pragma unroll
                    for (int e = 0; e < 16; ++e) kf[e] = 0.f;
                }
                const float ksj = j < n ? kscale[j] : 0.f;
                for (int r = 0; r < nrep; ++r) {
                    const float* qr = sQ + r * D + sub * 16;
                    float dot = 0.f;
#pragma unroll
                    for (int e = 0; e < 16; ++e) dot += qr[e] * kf[e];
#pragma unroll
                    for (int o = KT / 2; o > 0; o >>= 1)
                        dot += __shfl_xor_sync(0xffffffffu, dot, o);
                    if (sub == 0 && j < n) sS[r * ps + j] = dot * ksj;
                }
            }
        } else {
            // Scores: warp w takes slots w, w + 4, ...; lanes split D.
            for (int j = warp; j < n; j += NWARP) {
                float kf[VEC];
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                    kf[e] = orion::to_f(kpage[j * D + lane * VEC + e]);
                for (int r = 0; r < nrep; ++r) {
                    float dot = 0.f;
#pragma unroll
                    for (int e = 0; e < VEC; ++e)
                        dot += sQ[r * D + lane * VEC + e] * kf[e];
                    dot = orion::warp_sum(dot);
                    if (lane == 0) sS[r * ps + j] = dot;
                }
            }
        }
        __syncthreads();

        // Online-softmax update: warp w takes heads w, w + 4, ...  l sums
        // the unscaled p; D' then folds the V scale into the stored p.
        const float* vscale = Quantized ? p.vs + ph * ps : nullptr;
        for (int r = warp; r < nrep; r += NWARP) {
            float mx = -INFINITY;
            for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sS[r * ps + j]);
            const float m_old = sM[r];
            const float m_new = fmaxf(m_old, orion::warp_max(mx));
            float sum = 0.f;
            for (int j = lane; j < n; j += 32) {
                const float pr = expf(sS[r * ps + j] - m_new);
                sum += pr;
                sS[r * ps + j] = Quantized ? pr * vscale[j] : pr;
            }
            sum = orion::warp_sum(sum);
            if (lane == 0) {
                const float alpha = expf(m_old - m_new);
                sA[r] = alpha;
                sL[r] = sL[r] * alpha + sum;
                sM[r] = m_new;
            }
        }
        __syncthreads();

        // acc = acc * alpha + P @ V; group g takes slots g, g + SPLIT, ...
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r) {
            if (r >= nrep) break;
            const float a = sA[r];
#pragma unroll
            for (int c = 0; c < S::NACC; ++c) acc[r][c] *= a;
        }
        for (int j = g; j < n; j += S::SPLIT) {
            float vv[S::NACC];
            if constexpr (Quantized) {
                const int2 raw = *reinterpret_cast<const int2*>(
                    vpage + (long long)j * D + c0);
                unpack4(raw.x, vv);
                unpack4(raw.y, vv + 4);
            } else {
#pragma unroll
                for (int c = 0; c < S::NACC; ++c)
                    vv[c] = orion::to_f(vpage[j * D + c0 + c * S::CSTRIDE]);
            }
#pragma unroll
            for (int r = 0; r < MAX_REP; ++r) {
                if (r >= nrep) break;
                const float pr = sS[r * ps + j];
#pragma unroll
                for (int c = 0; c < S::NACC; ++c) acc[r][c] += pr * vv[c];
            }
        }
        __syncthreads();
    }

    // Sum the token-parallel groups, normalise, write.
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
        if (r >= nrep) break;
#pragma unroll
        for (int c = 0; c < S::NACC; ++c)
            sR[(g * nrep + r) * D + c0 + c * S::CSTRIDE] = acc[r][c];
    }
    __syncthreads();
    T* ob = static_cast<T*>(p.o) + b * p.sob;
    for (int e = tid; e < nrep * D; e += NT) {
        const int r = e / D, d = e % D;
        float s = 0.f;
#pragma unroll
        for (int gg = 0; gg < S::SPLIT; ++gg) s += sR[(gg * nrep + r) * D + d];
        ob[(h0 + r) * p.soh + d] = orion::from_f<T>(s / fmaxf(sL[r], 1e-30f));
    }
}

template <typename T, int D, bool Quantized>
int launch(const DecodeParams& p, cudaStream_t stream) {
    const int nrep = p.H / p.Hkv;
    const size_t smem = smem_bytes<D, Quantized>(nrep, p.ps);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            paged_decode_kernel<T, D, Quantized>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    dim3 grid(p.Hkv, p.B);
    paged_decode_kernel<T, D, Quantized><<<grid, NT, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename T, bool Quantized>
int dispatch_d(int D, const DecodeParams& p, cudaStream_t stream) {
    switch (D) {
        case 64: return launch<T, 64, Quantized>(p, stream);
        case 128: return launch<T, 128, Quantized>(p, stream);
        case 256: return launch<T, 256, Quantized>(p, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <bool Quantized>
int run(const DecodeParams& p, int D, int dtype, void* stream) {
    if (p.H % p.Hkv != 0 || p.H / p.Hkv > MAX_REP)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch_d<float, Quantized>(D, p, s);
    if (dtype == 1) return dispatch_d<__nv_bfloat16, Quantized>(D, p, s);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// Kernel D.  dtype (q, pools and out): 0 = float32, 1 = bfloat16.  Pools
// contiguous [N, Hkv, ps, D].  Returns the launch's cudaError_t.
extern "C" int orion_paged_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const int* block_tables, const int* seq_lens, void* o,
    int B, int H, int Hkv, int D, int ps, int max_pages,
    long long sqb, long long sqh, long long sob, long long soh,
    float scale, int dtype, void* stream) {
    DecodeParams p{q, k_pages, v_pages, nullptr, nullptr, block_tables,
                   seq_lens, o, B, H, Hkv, ps, max_pages, sqb, sqh, sob,
                   soh, scale};
    return run<false>(p, D, dtype, stream);
}

// Kernel D'.  int8 pools contiguous [N, Hkv, ps, D] (16-byte aligned),
// f32 scale pools contiguous [N, Hkv, 1, ps]; dtype (q and out):
// 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int orion_paged_decode_int8(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scales, const float* v_scales,
    const int* block_tables, const int* seq_lens, void* o,
    int B, int H, int Hkv, int D, int ps, int max_pages,
    long long sqb, long long sqh, long long sob, long long soh,
    float scale, int dtype, void* stream) {
    DecodeParams p{q, k_pages, v_pages, k_scales, v_scales, block_tables,
                   seq_lens, o, B, H, Hkv, ps, max_pages, sqb, sqh, sob,
                   soh, scale};
    return run<true>(p, D, dtype, stream);
}
