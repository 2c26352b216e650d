// The aligned detect kernel, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel:
//   K17 orbitanalysis_tpu/ops/pallas_step.py _static_kernel (call :360,
//       entry fused_static_detect :375) -> static_detect_rows below
//
// Prev and cur planes are aligned: a matched pair sits at the same
// position of both [H, P] rows, so detection is elementwise and there is
// no merge.  Two modes, as on the TPU:
//   native = 1: the aligned engine's carry-native step
//     (make_aligned_native_step(detect_impl='pallas')): FRESH (the
//     position's tenant changed) is bit 27 of the cur sv, and the prev
//     angle plane is the packed carry word (f32 angle bits 0-30, match
//     flag bit 31);
//   native = 0: the legacy select-staged step (make_aligned_orbit_step):
//     FRESH is bit 27 of the prev sv, and the prev angles are float32.
// Two launches:
//   1. grid (H, P / 256), one lane a thread, _static_kernel's chain line
//      for line: valid = (ck >> 1) != invalid; the clipped cosine
//      ((prx*crx + pry*cry) + prz*crz) and common.cuh's Cephes arccos
//      (0 on invalid lanes); the peri/apocentric flip on the sv >> 24
//      sign bits; apsis = valid & flip & ~fresh; angle_acc = fresh ? 0 :
//      pang + dtheta.  It writes packed = f32_bits(apsis | ~valid ? 0 :
//      angle_acc) | (valid & ~fresh) << 31, and the event word
//      f32_bits(angle_acc) | 1 << 31 where an apsis fired (else 0) to an
//      [H, P] scratch plane;
//   2. common.cuh's ordered scan moves (ck, psv, event word) of each event
//      to the front of [H, k128] rows in position order (the angle with
//      bit 31 cleared) and writes the exact count a row, which may exceed
//      k128: no TPU block cap and no [8, 128] count tile.  The event's sv
//      is the PREV sv, so its low 24 bits are the prev load slot.
// Every float operation is the plain version's, in its order; the build
// passes --fmad=false and IEEE sqrtf, so kernel and plain version
// (ops/step.py fused_static_detect_torch) agree bit for bit.
//
// What bounds it on the H100: bytes.  At the bench shape [64, 32768] the
// detect pass reads 10 planes (84 MB) and writes packed (8.4 MB) and the
// scratch plane; the scan reads the scratch plane whole and ck / psv only
// at the events.  Simple first: the scratch plane round trip and the
// one-block-a-row scan (64 of 132 SMs) are where a faster version goes.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct StaticArgs {
  const int32_t* psv;    // [H, P] slot | vrb << 24 (bit 27: FRESH, legacy)
  const float* prx;
  const float* pry;
  const float* prz;
  const uint32_t* pang;  // f32 angle bits (legacy) or the packed carry word
  const uint32_t* ck;    // [H, P] cur keys (id or position) << 1 | 1
  const int32_t* csv;    // slot | vrb << 24 (bit 27: FRESH, native)
  const float* crx;
  const float* cry;
  const float* crz;
  uint32_t* packed;      // [H, P]
  uint32_t* evp;         // [H, P] scratch for the compaction
  long long n;           // H * P
  uint32_t invalid;      // the padding ID
  int pericentric;
  int native;
};

__global__ void __launch_bounds__(kThreads)
static_detect_kernel(StaticArgs a) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const bool valid = (a.ck[i] >> 1) != a.invalid;
  const int vrb_p = a.psv[i] >> 24;
  const int vrb_c = a.csv[i] >> 24;
  const bool fresh = ((a.native ? vrb_c : vrb_p) & 8) != 0;
  const uint32_t pw = a.pang[i];
  const float pang = __uint_as_float(a.native ? (pw & 0x7FFFFFFFu) : pw);
  float dtheta = 0.0f;
  if (valid) {
    float cs = a.prx[i] * a.crx[i] + a.pry[i] * a.cry[i];
    cs = cs + a.prz[i] * a.crz[i];
    dtheta = acos_f32(fminf(fmaxf(cs, -1.0f), 1.0f));
  }
  const bool flip = a.pericentric ? ((vrb_p & 1) && (vrb_c & 2)) : ((vrb_p & 2) && (vrb_c & 1));
  const bool apsis = valid && flip && !fresh;
  const float angle_acc = fresh ? 0.0f : pang + dtheta;
  a.packed[i] = __float_as_uint((apsis || !valid) ? 0.0f : angle_acc) |
                ((valid && !fresh) ? 0x80000000u : 0u);
  a.evp[i] = apsis ? (__float_as_uint(angle_acc) | 0x80000000u) : 0u;
}

}  // namespace

// Entry point: launches on the caller's stream, returns cudaGetLastError()
// (0 = launched).  Pointers are device pointers to C-contiguous [H, P]
// planes of 32-bit words.  Outputs: packed [H, P], evp [H, P] (scratch),
// ev_key / ev_sv / ev_ang [H, k128] (zero past each row's count; ev_ang
// holds the f32 angle bits), count [H] (exact, may exceed k128).
extern "C" int static_detect_rows(
    const void* psv, const void* prx, const void* pry, const void* prz,
    const void* pang, const void* ck, const void* csv, const void* crx,
    const void* cry, const void* crz, void* packed, void* evp, void* ev_key,
    void* ev_sv, void* ev_ang, void* count, int H, int P, int k128,
    int invalid, int pericentric, int native, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(H) * P;
  if (n > 0) {
    StaticArgs a;
    a.psv = static_cast<const int32_t*>(psv);
    a.prx = static_cast<const float*>(prx);
    a.pry = static_cast<const float*>(pry);
    a.prz = static_cast<const float*>(prz);
    a.pang = static_cast<const uint32_t*>(pang);
    a.ck = static_cast<const uint32_t*>(ck);
    a.csv = static_cast<const int32_t*>(csv);
    a.crx = static_cast<const float*>(crx);
    a.cry = static_cast<const float*>(cry);
    a.crz = static_cast<const float*>(crz);
    a.packed = static_cast<uint32_t*>(packed);
    a.evp = static_cast<uint32_t*>(evp);
    a.n = n;
    a.invalid = static_cast<uint32_t>(invalid);
    a.pericentric = pericentric;
    a.native = native;
    const long long blocks = (n + kThreads - 1) / kThreads;
    static_detect_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  StreamGroup g{};
  g.sel = static_cast<const uint32_t*>(evp);
  g.sel_mask = 0x80000000u;
  const void* in[3] = {ck, psv, evp};
  void* out[3] = {ev_key, ev_sv, ev_ang};
  const uint32_t mask[3] = {0xFFFFFFFFu, 0xFFFFFFFFu, 0x7FFFFFFFu};
  for (int c = 0; c < 3; ++c) {
    g.in[c] = static_cast<const uint32_t*>(in[c]);
    g.out[c] = static_cast<uint32_t*>(out[c]);
    g.out_mask[c] = mask[c];
  }
  g.n_streams = 3;
  g.len = k128;
  g.count = static_cast<int32_t*>(count);
  return launch_compact_streams(g, nullptr, H, P, s);
}
