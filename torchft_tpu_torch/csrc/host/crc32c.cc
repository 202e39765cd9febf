// CRC32C (Castagnoli, reflected polynomial 0x82F63B78) for the heal wire's
// integrity frames: the SSE4.2 crc32 instruction where the CPU has it
// (several GB/s), a byte table elsewhere. Linked into the port's build of
// the native control plane (torchft_tpu_torch/control/_native.py) and called
// through ctypes by torchft_tpu_torch/utils/crc32c.py.
#include <stddef.h>
#include <stdint.h>
#include <string.h>
#if defined(__x86_64__)
#include <nmmintrin.h>
#endif

namespace {

uint32_t table[256];
bool table_ready = false;

void make_table() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1u)));
    table[i] = c;
  }
  table_ready = true;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2"))) uint32_t crc_hw(uint32_t crc,
                                                  const unsigned char* p,
                                                  size_t n) {
  uint64_t c = crc;
  while (n >= 8) {
    uint64_t v;
    memcpy(&v, p, 8);
    c = _mm_crc32_u64(c, v);
    p += 8;
    n -= 8;
  }
  crc = (uint32_t)c;
  while (n--) crc = _mm_crc32_u8(crc, *p++);
  return crc;
}
#endif

}  // namespace

// CRC32C of n bytes at data, continuing from a previous value (0 to start).
extern "C" uint32_t tft_crc32c(uint32_t value, const void* data, size_t n) {
  const unsigned char* p = (const unsigned char*)data;
  uint32_t crc = value ^ 0xFFFFFFFFu;
#if defined(__x86_64__)
  if (__builtin_cpu_supports("sse4.2")) return crc_hw(crc, p, n) ^ 0xFFFFFFFFu;
#endif
  if (!table_ready) make_table();
  while (n--) crc = (crc >> 8) ^ table[(crc ^ *p++) & 0xFFu];
  return crc ^ 0xFFFFFFFFu;
}
