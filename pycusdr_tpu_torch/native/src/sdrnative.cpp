// Native host runtime for pycusdr_tpu_torch (a copy of pycusdr_tpu/native/src/sdrnative.cpp).
//
// The reference's native layer is its CUDA kernel suite + cuFFT FFI
// (pyCuSDR/demodulator/cuda_kernels.cu, lib/cufft.py). On TPU the
// device math lives in XLA/Pallas; what remains hot on the HOST is the
// streaming edge: IQ re-blocking, complex->split-planar conversion for
// the device graph, the decoder's header/sync correlation sweep, and
// the per-packet PN9/CRC bit twiddling. Those live here, exposed as a
// plain C ABI consumed via ctypes (no pybind11 dependency).
//
// Build: pycusdr_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC, at
// first use, into build/native/).

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// Ring buffer for complex64 samples (parity: pyCuSDR/sigFIFO.py:13-104).
// Stores interleaved (re, im) float pairs; indices are in samples.
// ---------------------------------------------------------------------------

typedef struct {
    float*  buf;       // 2 * cap floats
    int64_t cap;       // capacity in samples
    int64_t head;      // write index (samples)
    int64_t tail;      // read index (samples)
    int64_t size;      // samples currently buffered
} rb_t;

rb_t* rb_create(int64_t cap_samples) {
    rb_t* rb = (rb_t*)std::malloc(sizeof(rb_t));
    if (!rb) return nullptr;
    rb->buf = (float*)std::malloc(sizeof(float) * 2 * cap_samples);
    if (!rb->buf) { std::free(rb); return nullptr; }
    rb->cap = cap_samples;
    rb->head = rb->tail = rb->size = 0;
    return rb;
}

void rb_destroy(rb_t* rb) {
    if (!rb) return;
    std::free(rb->buf);
    std::free(rb);
}

void rb_flush(rb_t* rb) { rb->head = rb->tail = rb->size = 0; }

int64_t rb_size(const rb_t* rb) { return rb->size; }

// Insert n samples; on overflow the buffer is flushed first (real-time
// stream: stale data is worthless). Oversized chunks keep their tail.
// Returns the buffered size after insertion.
int64_t rb_insert(rb_t* rb, const float* data, int64_t n) {
    if (n > rb->cap) {              // keep only the newest cap samples
        data += 2 * (n - rb->cap);
        n = rb->cap;
    }
    if (rb->size + n > rb->cap) rb_flush(rb);

    int64_t end = rb->head + n;
    if (end > rb->cap) {
        int64_t first = rb->cap - rb->head;
        std::memcpy(rb->buf + 2 * rb->head, data, sizeof(float) * 2 * first);
        std::memcpy(rb->buf, data + 2 * first, sizeof(float) * 2 * (n - first));
        rb->head = n - first;
    } else {
        std::memcpy(rb->buf + 2 * rb->head, data, sizeof(float) * 2 * n);
        rb->head = (end == rb->cap) ? 0 : end;
    }
    rb->size += n;
    return rb->size;
}

// Pop exactly n samples into out; returns n, or 0 if not enough buffered.
int64_t rb_pop(rb_t* rb, float* out, int64_t n) {
    if (rb->size < n) return 0;
    int64_t end = rb->tail + n;
    if (end > rb->cap) {
        int64_t first = rb->cap - rb->tail;
        std::memcpy(out, rb->buf + 2 * rb->tail, sizeof(float) * 2 * first);
        std::memcpy(out + 2 * first, rb->buf, sizeof(float) * 2 * (n - first));
        rb->tail = n - first;
    } else {
        std::memcpy(out, rb->buf + 2 * rb->tail, sizeof(float) * 2 * n);
        rb->tail = (end == rb->cap) ? 0 : end;
    }
    rb->size -= n;
    return n;
}

// ---------------------------------------------------------------------------
// complex64 (interleaved) -> split planar float32 [re | im].
// The device graph is complex-free (ops/cfft.py); this is the per-block
// host boundary conversion.
// ---------------------------------------------------------------------------

void deinterleave_c64(const float* in, float* re, float* im, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        re[i] = in[2 * i];
        im[i] = in[2 * i + 1];
    }
}

void interleave_c64(const float* re, const float* im, float* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        out[2 * i]     = re[i];
        out[2 * i + 1] = im[i];
    }
}

// ---------------------------------------------------------------------------
// Full convolution of a {0,1} bit stream with a ±1 mask
// (parity: np.convolve in pyCuSDR/decoder.py:96-114). out has
// n + m - 1 entries. Only set bits contribute, so we scatter the mask
// at each set bit — ~n/2 * m adds, vectorised by the compiler.
// ---------------------------------------------------------------------------

void convolve_bits_i8(const int8_t* bits, int64_t n, const int8_t* mask,
                      int64_t m, int32_t* out) {
    std::memset(out, 0, sizeof(int32_t) * (n + m - 1));
    for (int64_t j = 0; j < n; ++j) {
        if (bits[j]) {
            int32_t* o = out + j;
            for (int64_t i = 0; i < m; ++i) o[i] += mask[i];
        }
    }
}

// ---------------------------------------------------------------------------
// PN9 whitening (x^9 + x^5 + 1, seed 0x1FF) over bytes
// (parity: pyCuSDR/lib/shift_registers.py PN9).
// ---------------------------------------------------------------------------

void pn9_xor(uint8_t* data, int64_t n) {
    uint16_t state = 0x1FF;
    for (int64_t i = 0; i < n; ++i) {
        uint8_t w = 0;
        for (int b = 0; b < 8; ++b) {
            w |= (uint8_t)((state & 1) << b);
            uint16_t fb = ((state & 1) ^ ((state >> 5) & 1)) & 1;
            state = (uint16_t)((state >> 1) | (fb << 8));
        }
        data[i] ^= w;
    }
}

// ---------------------------------------------------------------------------
// CRC-16 poly 0x8005 (CC11xx: 0x18005, init 0xFFFF, MSB-first)
// (parity: crcmod usage in pyCuSDR/modulator/encoders/CC11xx.py).
// ---------------------------------------------------------------------------

uint16_t crc16_8005(const uint8_t* data, int64_t n, uint16_t init) {
    uint16_t crc = init;
    for (int64_t i = 0; i < n; ++i) {
        crc ^= (uint16_t)(data[i] << 8);
        for (int b = 0; b < 8; ++b) {
            crc = (crc & 0x8000) ? (uint16_t)((crc << 1) ^ 0x8005)
                                 : (uint16_t)(crc << 1);
        }
    }
    return crc;
}

}  // extern "C"
