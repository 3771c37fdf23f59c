// Kernel D, paged_decode: one decode step of attention over the paged
// KV pool, through per-sequence block tables.
//
// Replaces: orion_tpu/ops/pallas/paged_attention.py,
// paged_decode_attention (kernel body _decode_kernel) with bf16/f32
// pools (quantized=False).  The int8-pool form is not ported yet.
//
// Semantics: q [B, H, D] (one token per sequence); pools
// [N, Hkv, ps, D]; block_tables [B, max_pages] int32 (entry j = the
// pool page holding positions [j*ps, (j+1)*ps)); seq_lens [B] int32,
// the number of valid tokens including the current one.  Online
// softmax in f32 across pages, slots idx >= seq_len masked inside the
// last page, output [B, H, D] in q's type.
//
// Design.  The TPU kernel's grid (batch, q-head, page) with scratch
// carried across the sequential page axis becomes one block per
// (kv head, sequence) that loops over its own ceil(seq_len / ps) pages,
// reading block_tables[b, j] itself (the TPU kernel's scalar
// prefetch).  The block serves all H / Hkv query heads of its kv head,
// so every page is read from device memory once, not once per query
// head; table entries past the last page in use are never read.
//
// Bound on this card: bytes.  A step reads every valid K and V row
// once (2 * 2 * seq_len * Hkv * D bytes per sequence in bf16) and does
// only ~4 * D * H / Hkv flops per row, far below the card's ~295
// flop-per-byte balance point.  This first version loads pages with
// plain coalesced loads, one page at a time per block, so it is
// latency-bound below the bandwidth bound; overlapping page loads
// (cp.async or TMA double buffering) is later work.

#include "common.cuh"

namespace {

constexpr int NT = 128;       // 4 warps
constexpr int NWARP = NT / 32;
constexpr int MAX_REP = 8;    // query heads per kv head

struct DecodeParams {
    const void* q;
    const void* kp;
    const void* vp;
    const int* bt;
    const int* lens;
    void* o;
    int B, H, Hkv, ps, max_pages;
    long long sqb, sqh, sob, soh;
    float scale;
};

template <int D>
size_t smem_bytes(int nrep, int ps) {
    constexpr int CSPAN = D < NT ? D : NT;
    constexpr int SPLIT = NT / CSPAN;
    return sizeof(float) * (size_t(nrep) * D + size_t(nrep) * ps + 3 * nrep +
                            size_t(SPLIT) * nrep * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_decode_kernel(DecodeParams p) {
    constexpr int VEC = D / 32;               // K elements per lane
    constexpr int CSPAN = D < NT ? D : NT;    // V columns per pass
    constexpr int CPT = D / CSPAN;            // V columns per thread
    constexpr int SPLIT = NT / CSPAN;         // token-parallel groups

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
    const int c0 = tid % CSPAN;
    const int g = tid / CSPAN;
    float acc[MAX_REP][CPT];
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

    const long long head_elems = (long long)ps * D;
    for (int pg = 0; pg < npages; ++pg) {
        const long long page = p.bt[(long long)b * p.max_pages + pg];
        const int n = min(ps, seq_len - pg * ps);
        const T* kpage = static_cast<const T*>(p.kp) +
                         (page * p.Hkv + hk) * head_elems;
        const T* vpage = static_cast<const T*>(p.vp) +
                         (page * p.Hkv + hk) * head_elems;

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
        __syncthreads();

        // Online-softmax update: warp w takes heads w, w + 4, ...
        for (int r = warp; r < nrep; r += NWARP) {
            float mx = -INFINITY;
            for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sS[r * ps + j]);
            const float m_old = sM[r];
            const float m_new = fmaxf(m_old, orion::warp_max(mx));
            float sum = 0.f;
            for (int j = lane; j < n; j += 32) {
                const float pr = expf(sS[r * ps + j] - m_new);
                sS[r * ps + j] = pr;
                sum += pr;
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
            for (int c = 0; c < CPT; ++c) acc[r][c] *= a;
        }
        for (int j = g; j < n; j += SPLIT) {
            float vv[CPT];
#pragma unroll
            for (int c = 0; c < CPT; ++c)
                vv[c] = orion::to_f(vpage[j * D + c0 + c * CSPAN]);
#pragma unroll
            for (int r = 0; r < MAX_REP; ++r) {
                if (r >= nrep) break;
                const float pr = sS[r * ps + j];
#pragma unroll
                for (int c = 0; c < CPT; ++c) acc[r][c] += pr * vv[c];
            }
        }
        __syncthreads();
    }

    // Sum the token-parallel groups, normalise, write.
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
        if (r >= nrep) break;
#pragma unroll
        for (int c = 0; c < CPT; ++c)
            sR[(g * nrep + r) * D + c0 + c * CSPAN] = acc[r][c];
    }
    __syncthreads();
    T* ob = static_cast<T*>(p.o) + b * p.sob;
    for (int e = tid; e < nrep * D; e += NT) {
        const int r = e / D, d = e % D;
        float s = 0.f;
#pragma unroll
        for (int gg = 0; gg < SPLIT; ++gg) s += sR[(gg * nrep + r) * D + d];
        ob[(h0 + r) * p.soh + d] = orion::from_f<T>(s / fmaxf(sL[r], 1e-30f));
    }
}

template <typename T, int D>
int launch(const DecodeParams& p, cudaStream_t stream) {
    const int nrep = p.H / p.Hkv;
    const size_t smem = smem_bytes<D>(nrep, p.ps);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            paged_decode_kernel<T, D>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    dim3 grid(p.Hkv, p.B);
    paged_decode_kernel<T, D><<<grid, NT, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const DecodeParams& p, cudaStream_t stream) {
    switch (D) {
        case 64: return launch<T, 64>(p, stream);
        case 128: return launch<T, 128>(p, stream);
        case 256: return launch<T, 256>(p, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Pools contiguous [N, Hkv, ps, D].
// Returns the launch's cudaError_t.
extern "C" int orion_paged_decode(
    const void* q, const void* k_pages, const void* v_pages,
    const int* block_tables, const int* seq_lens, void* o,
    int B, int H, int Hkv, int D, int ps, int max_pages,
    long long sqb, long long sqh, long long sob, long long soh,
    float scale, int dtype, void* stream) {
    if (H % Hkv != 0 || H / Hkv > MAX_REP) return (int)cudaErrorInvalidValue;
    DecodeParams p{q, k_pages, v_pages, block_tables, seq_lens, o,
                   B, H, Hkv, ps, max_pages, sqb, sqh, sob, soh, scale};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return dispatch_d<float>(D, p, s);
    if (dtype == 1) return dispatch_d<__nv_bfloat16>(D, p, s);
    return (int)cudaErrorInvalidValue;
}
