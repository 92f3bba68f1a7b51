// Microkernels that check the yardsticks of the kernels' bounds
// (chip_smoke.py phases 1 and 20): what one 32x32->64-bit limb product
// costs on this card (the verify and dsm kernels), and what the hash
// kernels' integer instructions cost, in throughput and in latency.
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
// - alu_rate_kernel<CHAINS> runs CHAINS independent chains a thread of the
//   hash kernels' instruction mix, one LOP3 (a three-input xor), one IADD3
//   (a three-input add) and one SHF.L.W (a rotate) a step: the throughput
//   term of the hash kernels' bound (instructions over the card's rate).
// - alu_chain_kernel runs one such chain on one thread, every instruction
//   waiting on the last, and reads the SM clock around it: the cycles and
//   the time of one dependent instruction, the latency term of the bound
//   (a compression's dependent chain times it).
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

// x <- rotl((x ^ y ^ z) + y + z, 7): three dependent ALU instructions
#define TM_ALU_STEP(x, y, z)                                                    \
  asm volatile(                                                                 \
      "{\n\t.reg .b32 t;\n\tlop3.b32 %0, %0, %1, %2, 0x96;\n\t"             \
      "add.u32 t, %0, %1;\n\tadd.u32 %0, t, %2;\n\tshf.l.wrap.b32 %0, %0, %0, 7;\n\t}" \
      : "+r"(x)                                                                 \
      : "r"(y), "r"(z))

template <int CHAINS>
__global__ void alu_rate_kernel(int64_t* __restrict__ out, uint32_t y, uint32_t z, int iters) {
  const uint32_t seed = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t acc[CHAINS];
#pragma unroll
  for (int i = 0; i < CHAINS; ++i) acc[i] = seed * 7u + i;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < CHAINS; ++i) TM_ALU_STEP(acc[i], y, z);
  }
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < CHAINS; ++i) s ^= acc[i];
  out[seed] = s;
}

// one thread: out[0] the chain's value, out[1] the SM cycles of its
// iters x 16 steps. x starts from the thread index, so the chain runs on
// the vector ALU as the hash kernels' do: from launch arguments alone
// ptxas would put it on the uniform datapath (ULOP3, UIADD3, USHF).
__global__ void alu_chain_kernel(int64_t* __restrict__ out, uint32_t y, uint32_t z, int iters) {
  uint32_t x = (y ^ z) + threadIdx.x;
  const long long t0 = clock64();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 16; ++k) TM_ALU_STEP(x, y, z);
  }
  const long long t1 = clock64();
  out[0] = x;
  out[1] = t1 - t0;
}

int launch_alu(int chains, int64_t* out, int iters, int blocks, int threads, cudaStream_t s) {
  constexpr uint32_t y = 0x9E3779B9u, z = 0x7F4A7C15u;
  switch (chains) {
    case 4: alu_rate_kernel<4><<<blocks, threads, 0, s>>>(out, y, z, iters); break;
    case 8: alu_rate_kernel<8><<<blocks, threads, 0, s>>>(out, y, z, iters); break;
    case 16: alu_rate_kernel<16><<<blocks, threads, 0, s>>>(out, y, z, iters); break;
    case 32: alu_rate_kernel<32><<<blocks, threads, 0, s>>>(out, y, z, iters); break;
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

// mode 0 / 1: imad_rate_kernel<mode == 1, chains> (chains 4, 8, 16 or 32)
// on `blocks` x `threads` threads, each doing `iters` x `chains` products
// (twice that for wide); mode 2: alu_rate_kernel<chains>, `iters` x
// `chains` steps a thread; all write one int64 per thread to `out`. Mode
// 3: alu_chain_kernel on one thread (blocks, threads and chains unused),
// writing two int64. Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for another mode or chain count.
extern "C" int tm_imad_rate(int mode, int chains, int64_t* out, int iters, int blocks,
                            int threads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_rate<false>(chains, out, iters, blocks, threads, s);
    case 1: return launch_rate<true>(chains, out, iters, blocks, threads, s);
    case 2: return launch_alu(chains, out, iters, blocks, threads, s);
    case 3:
      alu_chain_kernel<<<1, 1, 0, s>>>(out, 0x9E3779B9u, 0x7F4A7C15u, iters);
      return static_cast<int>(cudaGetLastError());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
