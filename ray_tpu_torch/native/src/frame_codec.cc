// Native frame codec for the control-plane wire protocol.
//
// The control plane ships length-prefixed pickled frames over unix/TCP
// sockets (`ray_tpu_torch/core/protocol.py`).  The Python hot loop paid three
// per-frame costs on the receive side — struct.unpack, a bytes() copy of
// the payload, and an O(buffer) `del buf[:k]` memmove — and a per-frame
// pack+append on the send side.  The reference escapes the equivalent
// overhead with a GIL-released Cython submit path
// (`python/ray/_raylet.pyx:3111`); we use the same zero-dependency
// extern "C" + ctypes recipe as the shm object store instead:
//
//   * rtc_scan:   one call per socket-readiness event returns the
//                 offsets/lengths of EVERY complete frame in the receive
//                 buffer (Python then unpickles straight out of a
//                 memoryview and compacts once per drain).
//   * rtc_encode: assembles N (len, payload) pairs into one coalesced
//                 send buffer (one sendall per dispatch/done train).
//
// Wire format (unchanged, byte-identical to the pure-Python codec):
//   [u64 little-endian payload length][payload] ...
//
// Build: g++ -O3 -fPIC -shared -pthread -o librt_codec.so frame_codec.cc

#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t kHdr = 8;

inline uint64_t load_le64(const uint8_t* p) {
  // Byte-wise load: safe for unaligned offsets on every target; compiles
  // to a single mov on little-endian hosts.
  uint64_t v;
  memcpy(&v, p, sizeof(v));
  return v;  // host is little-endian (x86-64 / aarch64)
}

inline void store_le64(uint8_t* p, uint64_t v) { memcpy(p, &v, sizeof(v)); }

}  // namespace

extern "C" {

// Scan `buf[0:len]` for complete length-prefixed frames.
//
// Writes up to `max_frames` (payload offset, payload length) pairs into
// out_off/out_len and the number of bytes consumed through the last
// complete frame into *out_consumed (a trailing partial frame is left for
// the next recv).  Returns the number of frames found, or -1 if a frame
// declares a length above `max_frame_len` (stream corruption guard — the
// connection must be torn down, not fed to the allocator).
//
// A return of exactly max_frames with *out_consumed < len means the caller
// should scan again from buf + *out_consumed (more frames may follow).
long long rtc_scan(const uint8_t* buf, uint64_t len, uint64_t max_frame_len,
                   uint64_t* out_off, uint64_t* out_len, uint64_t max_frames,
                   uint64_t* out_consumed) {
  uint64_t pos = 0;
  uint64_t n = 0;
  while (n < max_frames && len - pos >= kHdr) {
    uint64_t flen = load_le64(buf + pos);
    if (flen > max_frame_len) {
      *out_consumed = pos;
      return -1;
    }
    if (len - pos - kHdr < flen) break;  // partial frame: wait for more
    out_off[n] = pos + kHdr;
    out_len[n] = flen;
    pos += kHdr + flen;
    n++;
  }
  *out_consumed = pos;
  return (long long)n;
}

// Assemble n frames into `dest`: [u64 len][payload] per entry.
// Returns total bytes written, or -1 if dest_cap is too small.
long long rtc_encode(const uint8_t* const* payloads, const uint64_t* lens,
                     uint64_t n, uint8_t* dest, uint64_t dest_cap) {
  uint64_t pos = 0;
  for (uint64_t i = 0; i < n; i++) {
    uint64_t flen = lens[i];
    if (dest_cap - pos < kHdr + flen) return -1;
    store_le64(dest + pos, flen);
    memcpy(dest + pos + kHdr, payloads[i], flen);
    pos += kHdr + flen;
  }
  return (long long)pos;
}

}  // extern "C"
