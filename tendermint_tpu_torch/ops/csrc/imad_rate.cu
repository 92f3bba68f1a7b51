// Microkernels that check the yardstick of the verify and dsm kernels'
// bound (chip_smoke.py phase 1): what one 32x32->64-bit limb product costs
// on this card.
//
// - imad_rate_kernel<WIDE, CHAINS> runs CHAINS independent multiply-add
//   chains a thread (4, 8, 16 or 32): WIDE = true issues two IMAD.WIDE
//   (signed 32x32->64, with a 64-bit addend in the second: the limb
//   products of fe25519.cuh) a step, WIDE = false one 32-bit IMAD.
//   chip_smoke.py sweeps the chains and the blocks an SM and takes the
//   plateau; the rates, products per second over the whole card, say what
//   one wide product costs against a 32-bit one, and the SASS of each loop
//   shows it issues its products and nothing else but the loop's own
//   counter and branch.
// - fe_mul_probe / fe_sq_probe do one fe_mul and one fe_sq of fe25519.cuh
//   each, so cuobjdump -sass shows how many IMAD.WIDE a field
//   multiplication and a squaring compile to. They are never launched.

#include "fe25519.cuh"

namespace {

// A step of a wide chain is two products, acc = hi(acc) * y1 + lo(acc) *
// y0, as fe_mul sums its columns: the first product starts the sum, the
// second adds to it. Nothing in it is loop-invariant (ptxas hoists a
// loop-invariant product out of the loop, leaving 64-bit adds), and no
// 64-bit addend is carried from one step to the next (ptxas splits such a
// loop-carried multiply-add into a product and a 64-bit add). So each wide
// step is two IMAD.WIDE in the SASS and each narrow step (acc = acc * y0 +
// acc) one IMAD, which chip_smoke.py checks.
template <bool WIDE, int CHAINS>
__global__ void imad_rate_kernel(int64_t* __restrict__ out, int32_t y0, int32_t y1, int iters) {
  const int32_t seed = static_cast<int32_t>(blockIdx.x * blockDim.x + threadIdx.x);
  if (WIDE) {
    int64_t acc[CHAINS];
#pragma unroll
    for (int i = 0; i < CHAINS; ++i) acc[i] = seed * 7 + i;
#pragma unroll 1
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int i = 0; i < CHAINS; ++i)
        asm volatile(
            "{\n\t.reg .b32 lo, hi;\n\tmov.b64 {lo, hi}, %0;\n\t"
            "mul.wide.s32 %0, lo, %1;\n\tmad.wide.s32 %0, hi, %2, %0;\n\t}"
            : "+l"(acc[i])
            : "r"(y0), "r"(y1));
    }
    int64_t s = 0;
#pragma unroll
    for (int i = 0; i < CHAINS; ++i) s ^= acc[i];
    out[seed] = s;
  } else {
    int32_t acc[CHAINS];
#pragma unroll
    for (int i = 0; i < CHAINS; ++i) acc[i] = seed * 7 + i;
#pragma unroll 1
    for (int it = 0; it < iters; ++it) {
#pragma unroll
      for (int i = 0; i < CHAINS; ++i)
        asm volatile("mad.lo.s32 %0, %0, %1, %0;" : "+r"(acc[i]) : "r"(y0));
    }
    int32_t s = 0;
#pragma unroll
    for (int i = 0; i < CHAINS; ++i) s ^= acc[i];
    out[seed] = s;
  }
}

template <bool WIDE>
int launch_rate(int chains, int64_t* out, int iters, int blocks, int threads, cudaStream_t s) {
  constexpr int32_t y0 = 0x2f1d3b, y1 = 0x2f1d6e;
  switch (chains) {
    case 4: imad_rate_kernel<WIDE, 4><<<blocks, threads, 0, s>>>(out, y0, y1, iters); break;
    case 8: imad_rate_kernel<WIDE, 8><<<blocks, threads, 0, s>>>(out, y0, y1, iters); break;
    case 16: imad_rate_kernel<WIDE, 16><<<blocks, threads, 0, s>>>(out, y0, y1, iters); break;
    case 32: imad_rate_kernel<WIDE, 32><<<blocks, threads, 0, s>>>(out, y0, y1, iters); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

TM_DEV Fe probe_load(const int32_t* __restrict__ p) {
  Fe f;
#pragma unroll
  for (int i = 0; i < 10; ++i) f.v[i] = p[10 * threadIdx.x + i];
  return f;
}

TM_DEV void probe_store(int32_t* __restrict__ p, const Fe& f) {
#pragma unroll
  for (int i = 0; i < 10; ++i) p[10 * threadIdx.x + i] = f.v[i];
}

}  // namespace

extern "C" __global__ void fe_mul_probe(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                                        int32_t* __restrict__ out) {
  probe_store(out, fe_mul(probe_load(a), probe_load(b)));
}

extern "C" __global__ void fe_sq_probe(const int32_t* __restrict__ a, int32_t* __restrict__ out) {
  probe_store(out, fe_sq(probe_load(a)));
}

// Launches imad_rate_kernel<wide != 0, chains> (chains 4, 8, 16 or 32) on
// `blocks` x `threads` threads, each doing `iters` x `chains` products
// (twice that for wide), writing one int64 per thread to `out`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for another
// chain count.
extern "C" int tm_imad_rate(int wide, int chains, int64_t* out, int iters, int blocks,
                            int threads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wide ? launch_rate<true>(chains, out, iters, blocks, threads, s)
              : launch_rate<false>(chains, out, iters, blocks, threads, s);
}
