// Native IO runtime for FMCWTPU0 raw recordings.
//
// The framework's data-loading hot path: header parsing, streaming frame
// reads, rx-channel deinterleave, and real/complex → pair-layout conversion,
// all in one pass over the file bytes (io/raw_format.py documents the
// container; this is its zero-copy native reader). Exposed as a C ABI for
// ctypes (no pybind11 in the deployment image).
//
// Layout recap (little-endian):
//   header : magic "FMCWTPU0", u32 version, u32 frame_count, u32 num_rx,
//            u32 n_cal, u32 pn, u32 nts, u32 flags (bit0: complex)
//   calib  : num_rx * 2 * n_cal float32 (per rx: I block then Q block)
//   frames : [frame][rx][chirp][sample] float32 (x2 when complex)

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

constexpr char kMagic[8] = {'F', 'M', 'C', 'W', 'T', 'P', 'U', '0'};
constexpr uint32_t kHeaderBytes = 8 + 7 * 4;

struct Header {
  uint32_t version;
  uint32_t frame_count;
  uint32_t num_rx;
  uint32_t n_cal;
  uint32_t pn;
  uint32_t nts;
  uint32_t flags;
};

int read_header(FILE* f, Header* h) {
  char magic[8];
  if (fread(magic, 1, 8, f) != 8) return -2;
  if (memcmp(magic, kMagic, 8) != 0) return -3;
  uint32_t fields[7];
  if (fread(fields, 4, 7, f) != 7) return -2;
  h->version = fields[0];
  h->frame_count = fields[1];
  h->num_rx = fields[2];
  h->n_cal = fields[3];
  h->pn = fields[4];
  h->nts = fields[5];
  h->flags = fields[6];
  if (h->version != 1) return -4;
  return 0;
}

uint64_t frames_offset(const Header& h) {
  return kHeaderBytes + uint64_t(h.num_rx) * 2 * h.n_cal * 4;
}

}  // namespace

extern "C" {

// Fills out[7] = {version, frame_count, num_rx, n_cal, pn, nts, flags}.
int fmcw_parse_header(const char* path, uint32_t* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Header h;
  int rc = read_header(f, &h);
  fclose(f);
  if (rc != 0) return rc;
  out[0] = h.version;
  out[1] = h.frame_count;
  out[2] = h.num_rx;
  out[3] = h.n_cal;
  out[4] = h.pn;
  out[5] = h.nts;
  out[6] = h.flags;
  return 0;
}

// Reads calibration blocks of antenna `rx`: n_cal I values then n_cal Q
// values into out (2 * n_cal floats).
int fmcw_read_calib(const char* path, uint32_t rx, float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Header h;
  int rc = read_header(f, &h);
  if (rc != 0) {
    fclose(f);
    return rc;
  }
  if (rx >= h.num_rx) {
    fclose(f);
    return -5;
  }
  uint64_t off = kHeaderBytes + uint64_t(rx) * 2 * h.n_cal * 4;
  if (fseek(f, long(off), SEEK_SET) != 0) {
    fclose(f);
    return -2;
  }
  size_t n = size_t(2) * h.n_cal;
  rc = fread(out, 4, n, f) == n ? 0 : -2;
  fclose(f);
  return rc;
}

// Streams frames [start, start+count) of antenna `rx` into `out` laid out
// as [count, pn, nts, 2] float32 (the device pair layout). Real recordings
// (flags bit0 == 0) get imag = 0. Returns 0 on success.
int fmcw_read_frames_pair(const char* path, uint32_t start, uint32_t count,
                          uint32_t rx, float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Header h;
  int rc = read_header(f, &h);
  if (rc != 0) {
    fclose(f);
    return rc;
  }
  if (rx >= h.num_rx || start + count > h.frame_count) {
    fclose(f);
    return -5;
  }
  const bool is_complex = (h.flags & 1u) != 0;
  const uint64_t vals_per_chan = uint64_t(h.pn) * h.nts;  // per rx per frame
  const uint64_t elem_bytes = is_complex ? 8 : 4;
  const uint64_t chan_bytes = vals_per_chan * elem_bytes;
  const uint64_t frame_bytes = chan_bytes * h.num_rx;
  const uint64_t base = frames_offset(h);

  // One contiguous channel block per frame; buffered read + convert.
  float* buf = new float[vals_per_chan * (is_complex ? 2 : 1)];
  for (uint32_t i = 0; i < count; ++i) {
    uint64_t off = base + uint64_t(start + i) * frame_bytes + rx * chan_bytes;
    if (fseek(f, long(off), SEEK_SET) != 0) {
      rc = -2;
      break;
    }
    size_t nvals = vals_per_chan * (is_complex ? 2 : 1);
    if (fread(buf, 4, nvals, f) != nvals) {
      rc = -2;
      break;
    }
    float* dst = out + uint64_t(i) * vals_per_chan * 2;
    if (is_complex) {
      // complex64 storage is already (re, im) interleaved == pair layout.
      memcpy(dst, buf, vals_per_chan * 2 * 4);
    } else {
      for (uint64_t v = 0; v < vals_per_chan; ++v) {
        dst[2 * v] = buf[v];
        dst[2 * v + 1] = 0.0f;
      }
    }
  }
  delete[] buf;
  fclose(f);
  return rc;
}

// Decimated complex calibration vector (radar_processing.m:167-174):
// out[nts, 2] pair from antenna rx's I/Q blocks with stride n_cal/nts.
int fmcw_calib_vector_pair(const char* path, uint32_t rx, uint32_t nts,
                           float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Header h;
  int rc = read_header(f, &h);
  if (rc != 0) {
    fclose(f);
    return rc;
  }
  fclose(f);
  if (rx >= h.num_rx || nts == 0 || h.n_cal % nts != 0) return -5;
  float* blocks = new float[size_t(2) * h.n_cal];
  rc = fmcw_read_calib(path, rx, blocks);
  if (rc == 0) {
    uint32_t dec = h.n_cal / nts;
    for (uint32_t k = 0; k < nts; ++k) {
      out[2 * k] = blocks[k * dec];               // I
      out[2 * k + 1] = blocks[h.n_cal + k * dec];  // Q
    }
  }
  delete[] blocks;
  return rc;
}

}  // extern "C"
