// K5, K6, K7: the (4,32)-record kernels, hand-written for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of scripts/probe_recmirror.py:
// cast_kernel (K5, :48), inv_kernel (K6, :68) and mirror_kernel (K7, :92,
// the standalone producer of softbody_tpu/ops/farfield4.py:mirror_table).
// Plain versions: softbody_tpu_torch/ops/cuda/recmirror.py
// (cast_rows_plain, uncast_rows_plain, mirror_records_plain).
//
// K5 casts [rows, 128] to [4*rows, 32] and K6 casts back.  On the TPU
// each is a relayout between two (8,128) tilings (a lane split merged
// into sublanes).  In row-major device memory both shapes hold the same
// bytes in the same order, so on this card each is a copy.
//
// K7 maps five planes [W, H] (px py vx vy alive) to the far apply's
// record table [(H'/mb)*(W'/4), 20*mb] of lane block mb (a multiple of
// 32; 32 by default, JAX's far_mb otherwise): record row b*(W'/4) + cx,
// lane f*4*mb + ix*mb + l holds plane f at (4cx + ix, mb*b + l), and 0
// where that cell lies outside [W, H] (the planes zero-padded to
// [W', H'], W' % 4 == 0, H' % mb == 0).  Reading the planes where they
// live and writing the padded table in one pass replaces the stack, the
// pad and the permute-copy of the plain version.
//
// What bounds them on the card: device-memory bytes, each input read
// once and each output written once; there is no arithmetic.  At the 1M
// bench shape K7 reads 20 MB and writes 20.6 MB, ~12 us at 3.35 TB/s.
// What the designs do about it: K5/K6 are float4 copies (16 bytes per
// thread per access, the widest load), four per thread with all loads
// issued before the stores, so each thread keeps 64 bytes in flight.
// K7 runs one block of 160 threads per 32-lane part of a record row
// (mb/32 blocks a row), four output floats per thread: warp f reads 32
// consecutive floats of each of plane f's rows 4cx..4cx+3 (float4 loads
// where the row is 16-byte aligned, as at H = 1000; scalar loads
// otherwise) and writes them as four runs of 128 contiguous bytes of the
// record row, float4 stores (at mb = 32 the field's 512 bytes in one
// run).  The bytes are the same at any mb, so is the bound.  The plane is
// picked by a switch on the warp-uniform f (indexing an array of
// pointers by f would put it in local memory, a stack round trip per
// thread).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COPY_THREADS = 256;
constexpr int COPY_UNROLL = 4;   // float4 per thread
constexpr int LANES = 32;        // lanes per block's part of a record
constexpr int RX = 4;            // plane rows per record
constexpr int NF = 5;            // px py vx vy alive
constexpr int PART = NF * RX * LANES;   // floats a block writes

__device__ __forceinline__ void copy_f4(const float4* __restrict__ in,
                                        float4* __restrict__ out,
                                        long long n4) {
  const long long base =
      (long long)blockIdx.x * (COPY_THREADS * COPY_UNROLL) + threadIdx.x;
  float4 v[COPY_UNROLL];
#pragma unroll
  for (int k = 0; k < COPY_UNROLL; ++k) {
    const long long i = base + (long long)k * COPY_THREADS;
    if (i < n4) v[k] = in[i];
  }
#pragma unroll
  for (int k = 0; k < COPY_UNROLL; ++k) {
    const long long i = base + (long long)k * COPY_THREADS;
    if (i < n4) out[i] = v[k];
  }
}

__global__ void __launch_bounds__(COPY_THREADS)
cast_rows_kernel(const float4* __restrict__ in, float4* __restrict__ out,
                 long long n4) {
  copy_f4(in, out, n4);
}

__global__ void __launch_bounds__(COPY_THREADS)
uncast_rows_kernel(const float4* __restrict__ in, float4* __restrict__ out,
                   long long n4) {
  copy_f4(in, out, n4);
}

struct Planes {
  const float* px;
  const float* py;
  const float* vx;
  const float* vy;
  const float* alive;
};

__device__ __forceinline__ const float* plane_of(const Planes& p, int f) {
  switch (f) {
    case 0: return p.px;
    case 1: return p.py;
    case 2: return p.vx;
    case 3: return p.vy;
    default: return p.alive;
  }
}

// grid (rows * mb/32), block PART/4: block `row * (mb/32) + p` writes
// part p of record row `row`, lanes 32p..32p+31 of each field's four
// plane rows; thread t the four lanes 32p + 4q..4q+3 of field f, plane
// row ix, stored as one float4.
__global__ void __launch_bounds__(PART / 4)
mirror_records_kernel(const Planes planes, float* __restrict__ out, int w,
                      int h, int cw, int mb) {
  const int parts = mb / LANES;
  const int row = blockIdx.x / parts;
  const int p = blockIdx.x - row * parts;
  const int t = threadIdx.x;
  const int f = t / (RX * LANES / 4);
  const int ix = (t / (LANES / 4)) % RX;
  const int q = t % (LANES / 4);
  const int b = row / cw;
  const int cx = row - b * cw;
  const int x = RX * cx + ix;
  const int lane = LANES * p + 4 * q;
  const int y = mb * b + lane;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (x < w) {
    const float* src = plane_of(planes, f) + (long long)x * h;
    if (y + 3 < h && ((uintptr_t)(src + y) % 16) == 0) {
      v = *reinterpret_cast<const float4*>(src + y);
    } else {
      if (y < h) v.x = src[y];
      if (y + 1 < h) v.y = src[y + 1];
      if (y + 2 < h) v.z = src[y + 2];
      if (y + 3 < h) v.w = src[y + 3];
    }
  }
  float* dst = out + (long long)row * (NF * RX * mb) + (f * RX + ix) * mb +
               lane;
  *reinterpret_cast<float4*>(dst) = v;
}

int copy_launch(bool cast, const float* in, float* out, long long n,
                void* stream) {
  if (n < 0 || n % 4 != 0) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)in % 16 != 0 || (uintptr_t)out % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long n4 = n / 4;
  if (n4 == 0) return (int)cudaSuccess;
  const long long per_block = (long long)COPY_THREADS * COPY_UNROLL;
  const long long blocks = (n4 + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float4* i4 = reinterpret_cast<const float4*>(in);
  float4* o4 = reinterpret_cast<float4*>(out);
  if (cast)
    cast_rows_kernel<<<(unsigned)blocks, COPY_THREADS, 0,
                       (cudaStream_t)stream>>>(i4, o4, n4);
  else
    uncast_rows_kernel<<<(unsigned)blocks, COPY_THREADS, 0,
                         (cudaStream_t)stream>>>(i4, o4, n4);
  return (int)cudaGetLastError();
}

}  // namespace

// K5: x [rows, 128] -> y [4*rows, 32], device pointers, 16-byte aligned.
extern "C" int sb_cast_rows(const float* x, float* y, long long rows,
                            void* stream) {
  if (rows < 0) return (int)cudaErrorInvalidValue;
  return copy_launch(true, x, y, rows * 128, stream);
}

// K6: y [4*rows, 32] -> x [rows, 128], device pointers, 16-byte aligned.
extern "C" int sb_uncast_rows(const float* y, float* x, long long rows,
                              void* stream) {
  if (rows < 0) return (int)cudaErrorInvalidValue;
  return copy_launch(false, y, x, rows * 128, stream);
}

// K7: five [w, h] planes (device pointers) -> out
// [(h_out/mb)*(w_out/4), 20*mb], lane block mb a positive multiple of 32.
extern "C" int sb_mirror_records(const float* px, const float* py,
                                 const float* vx, const float* vy,
                                 const float* alive, float* out, int w,
                                 int h, int w_out, int h_out, int mb,
                                 void* stream) {
  if (w < 0 || h < 0 || w_out < w || h_out < h || w_out % RX != 0 ||
      mb <= 0 || mb % LANES != 0 || h_out % mb != 0)
    return (int)cudaErrorInvalidValue;
  const int cw = w_out / RX;
  const long long blocks = (long long)(h_out / mb) * cw * (mb / LANES);
  if (blocks == 0) return (int)cudaSuccess;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Planes planes = {px, py, vx, vy, alive};
  if ((uintptr_t)out % 16 != 0) return (int)cudaErrorMisalignedAddress;
  mirror_records_kernel<<<(unsigned)blocks, PART / 4, 0,
                          (cudaStream_t)stream>>>(planes, out, w, h, cw, mb);
  return (int)cudaGetLastError();
}
