/*
 * =============================================================================
 * steimlib.c -- STEIM1/STEIM2 codec for miniSEED records.
 *
 * Host (CPU) component of quakemigrate_torch's seismic I/O layer, a copy of
 * the JAX package's core/src/steimlib.c, built with the host C compiler
 * (quakemigrate_torch/_build.py::build_host). The detect stage streams
 * day-length int32-scaled coalescence traces to .scanmseed files
 * (reference behaviour: quakemigrate/io/scanmseed.py:74-220), so the codec
 * must sustain tens of millions of samples per second. Frames are 64 bytes
 * (16 big-endian uint32 words); word 0 carries 2-bit nibble codes for the
 * other 15 words; frame 0 of each record carries the forward/reverse
 * integration constants in words 1-2.
 *
 * Part of quakemigrate_torch. License: GPLv3.
 * =============================================================================
 */

#include <stdint.h>
#include <string.h>

#define WORDS_PER_FRAME 16

static inline uint32_t be32(const uint8_t *p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

static inline uint32_t le32(const uint8_t *p) {
    return ((uint32_t)p[3] << 24) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[1] << 8) | (uint32_t)p[0];
}

/* swapflag nonzero => little-endian frame words (Blockette-1000
 * word_order 0); SEED nominally mandates big-endian but little-endian
 * STEIM payloads are common in the wild. */
static inline uint32_t word32(const uint8_t *p, int swapflag) {
    return swapflag ? le32(p) : be32(p);
}

static inline void put_be32(uint8_t *p, uint32_t v) {
    p[0] = (uint8_t)(v >> 24);
    p[1] = (uint8_t)(v >> 16);
    p[2] = (uint8_t)(v >> 8);
    p[3] = (uint8_t)v;
}

/* Sign-extend the low `bits` bits of v. */
static inline int32_t sext(uint32_t v, int bits) {
    uint32_t m = 1u << (bits - 1);
    v &= (bits == 32) ? 0xFFFFFFFFu : ((1u << bits) - 1u);
    return (int32_t)((v ^ m) - m);
}

/* Minimum signed bit-width classes used by the STEIM2 packer. */
static inline int bitclass2(int32_t d) {
    if (d >= -8 && d <= 7) return 4;
    if (d >= -16 && d <= 15) return 5;
    if (d >= -32 && d <= 31) return 6;
    if (d >= -128 && d <= 127) return 8;
    if (d >= -512 && d <= 511) return 10;
    if (d >= -16384 && d <= 16383) return 15;
    if (d >= -(1 << 29) && d <= (1 << 29) - 1) return 30;
    return 32;
}

/*
 * steim2_decode: unpack `nframes` 64-byte frames into int32 samples.
 * Returns the number of samples written to `out` (<= max_samples), or -1 on
 * malformed input.
 */
int64_t steim2_decode(const uint8_t *frames, int64_t nframes,
                      int64_t max_samples, int32_t *out, int swapflag) {
    int64_t n = 0;
    int32_t x0 = 0, last = 0;
    int have_x0 = 0;

    for (int64_t f = 0; f < nframes; ++f) {
        const uint8_t *frame = frames + f * 64;
        uint32_t ctrl = word32(frame, swapflag);
        for (int w = 1; w < WORDS_PER_FRAME; ++w) {
            int nib = (ctrl >> (2 * (WORDS_PER_FRAME - 1 - w))) & 3;
            uint32_t word = word32(frame + 4 * w, swapflag);
            if (f == 0 && w == 1) { x0 = (int32_t)word; have_x0 = 1; continue; }
            if (f == 0 && w == 2) { continue; } /* xn: reverse constant */
            if (nib == 0) continue;

            int32_t diffs[7];
            int nd = 0;
            if (nib == 1) {
                for (int i = 0; i < 4; ++i)
                    diffs[nd++] = (int8_t)((word >> (8 * (3 - i))) & 0xFF);
            } else if (nib == 2) {
                int dnib = word >> 30;
                if (dnib == 1) {
                    diffs[nd++] = sext(word, 30);
                } else if (dnib == 2) {
                    for (int i = 0; i < 2; ++i)
                        diffs[nd++] = sext(word >> (15 * (1 - i)), 15);
                } else if (dnib == 3) {
                    for (int i = 0; i < 3; ++i)
                        diffs[nd++] = sext(word >> (10 * (2 - i)), 10);
                } else {
                    return -1;
                }
            } else { /* nib == 3 */
                int dnib = word >> 30;
                if (dnib == 0) {
                    for (int i = 0; i < 5; ++i)
                        diffs[nd++] = sext(word >> (6 * (4 - i)), 6);
                } else if (dnib == 1) {
                    for (int i = 0; i < 6; ++i)
                        diffs[nd++] = sext(word >> (5 * (5 - i)), 5);
                } else if (dnib == 2) {
                    for (int i = 0; i < 7; ++i)
                        diffs[nd++] = sext(word >> (4 * (6 - i)), 4);
                } else {
                    return -1;
                }
            }
            for (int i = 0; i < nd && n < max_samples; ++i) {
                if (n == 0) {
                    last = have_x0 ? x0 : diffs[i];
                } else {
                    last += diffs[i];
                }
                out[n++] = last;
            }
        }
    }
    return n;
}

/*
 * steim1_decode: as steim2_decode but with the STEIM1 word codes
 * (01: 4x8bit, 10: 2x16bit, 11: 1x32bit).
 */
int64_t steim1_decode(const uint8_t *frames, int64_t nframes,
                      int64_t max_samples, int32_t *out, int swapflag) {
    int64_t n = 0;
    int32_t x0 = 0, last = 0;
    int have_x0 = 0;

    for (int64_t f = 0; f < nframes; ++f) {
        const uint8_t *frame = frames + f * 64;
        uint32_t ctrl = word32(frame, swapflag);
        for (int w = 1; w < WORDS_PER_FRAME; ++w) {
            int nib = (ctrl >> (2 * (WORDS_PER_FRAME - 1 - w))) & 3;
            uint32_t word = word32(frame + 4 * w, swapflag);
            if (f == 0 && w == 1) { x0 = (int32_t)word; have_x0 = 1; continue; }
            if (f == 0 && w == 2) { continue; }
            if (nib == 0) continue;

            int32_t diffs[4];
            int nd = 0;
            if (nib == 1) {
                for (int i = 0; i < 4; ++i)
                    diffs[nd++] = (int8_t)((word >> (8 * (3 - i))) & 0xFF);
            } else if (nib == 2) {
                for (int i = 0; i < 2; ++i)
                    diffs[nd++] = (int16_t)((word >> (16 * (1 - i))) & 0xFFFF);
            } else {
                diffs[nd++] = (int32_t)word;
            }
            for (int i = 0; i < nd && n < max_samples; ++i) {
                if (n == 0) {
                    last = have_x0 ? x0 : diffs[i];
                } else {
                    last += diffs[i];
                }
                out[n++] = last;
            }
        }
    }
    return n;
}

/*
 * steim2_encode: pack samples into up to `nframes` frames. `prev` is the
 * last sample of the previous record (used for the first difference), or
 * samples[0] for the first record (making the first diff 0).
 *
 * Returns the number of samples consumed; *frames_used receives the frame
 * count actually filled. Returns -1 if a difference overflows 30 bits
 * (caller should fall back to STEIM1 or INT32).
 */
int64_t steim2_encode(const int32_t *samples, int64_t nsamples, int32_t prev,
                      uint8_t *out, int64_t nframes, int64_t *frames_used) {
    if (nframes <= 0 || nsamples <= 0) {
        if (frames_used) *frames_used = 0;
        return 0;
    }
    memset(out, 0, (size_t)(nframes * 64));
    int64_t pos = 0;   /* next sample index to encode */
    int64_t f = 0;
    for (; f < nframes && pos < nsamples; ++f) {
        uint8_t *frame = out + f * 64;
        uint32_t ctrl = 0;
        int wstart = (f == 0) ? 3 : 1;
        for (int w = wstart; w < WORDS_PER_FRAME && pos < nsamples; ++w) {
            /* Determine diffs and their bit classes for the next 7 samples */
            int32_t d[7];
            int bc[7];
            int avail = (nsamples - pos) < 7 ? (int)(nsamples - pos) : 7;
            for (int i = 0; i < avail; ++i) {
                int32_t prev_s = (pos + i == 0) ? prev : samples[pos + i - 1];
                d[i] = samples[pos + i] - prev_s;
                bc[i] = bitclass2(d[i]);
            }
            uint32_t word = 0;
            int nib, count;
            if (avail >= 7 && bc[0] <= 4 && bc[1] <= 4 && bc[2] <= 4 &&
                bc[3] <= 4 && bc[4] <= 4 && bc[5] <= 4 && bc[6] <= 4) {
                nib = 3; count = 7;
                word = 2u << 30;
                for (int i = 0; i < 7; ++i)
                    word |= ((uint32_t)d[i] & 0xF) << (4 * (6 - i));
            } else if (avail >= 6 && bc[0] <= 5 && bc[1] <= 5 && bc[2] <= 5 &&
                       bc[3] <= 5 && bc[4] <= 5 && bc[5] <= 5) {
                nib = 3; count = 6;
                word = 1u << 30;
                for (int i = 0; i < 6; ++i)
                    word |= ((uint32_t)d[i] & 0x1F) << (5 * (5 - i));
            } else if (avail >= 5 && bc[0] <= 6 && bc[1] <= 6 && bc[2] <= 6 &&
                       bc[3] <= 6 && bc[4] <= 6) {
                nib = 3; count = 5;
                for (int i = 0; i < 5; ++i)
                    word |= ((uint32_t)d[i] & 0x3F) << (6 * (4 - i));
            } else if (avail >= 4 && bc[0] <= 8 && bc[1] <= 8 && bc[2] <= 8 &&
                       bc[3] <= 8) {
                nib = 1; count = 4;
                for (int i = 0; i < 4; ++i)
                    word |= ((uint32_t)d[i] & 0xFF) << (8 * (3 - i));
            } else if (avail >= 3 && bc[0] <= 10 && bc[1] <= 10 && bc[2] <= 10) {
                nib = 2; count = 3;
                word = 3u << 30;
                for (int i = 0; i < 3; ++i)
                    word |= ((uint32_t)d[i] & 0x3FF) << (10 * (2 - i));
            } else if (avail >= 2 && bc[0] <= 15 && bc[1] <= 15) {
                nib = 2; count = 2;
                word = 2u << 30;
                for (int i = 0; i < 2; ++i)
                    word |= ((uint32_t)d[i] & 0x7FFF) << (15 * (1 - i));
            } else if (bc[0] <= 30) {
                nib = 2; count = 1;
                word = (1u << 30) | ((uint32_t)d[0] & 0x3FFFFFFF);
            } else {
                return -1; /* difference needs > 30 bits */
            }
            put_be32(frame + 4 * w, word);
            ctrl |= (uint32_t)nib << (2 * (WORDS_PER_FRAME - 1 - w));
            pos += count;
        }
        put_be32(frame, ctrl);
    }
    /* Frame 0 words 1/2: forward & reverse integration constants */
    put_be32(out + 4, (uint32_t)samples[0]);
    put_be32(out + 8, (uint32_t)samples[pos - 1]);
    *frames_used = f;
    return pos;
}

/*
 * steim1_encode: as steim2_encode but with STEIM1 packings; cannot fail
 * (int32 wraparound differences always fit the 1x32bit code).
 */
int64_t steim1_encode(const int32_t *samples, int64_t nsamples, int32_t prev,
                      uint8_t *out, int64_t nframes, int64_t *frames_used) {
    if (nframes <= 0 || nsamples <= 0) {
        if (frames_used) *frames_used = 0;
        return 0;
    }
    memset(out, 0, (size_t)(nframes * 64));
    int64_t pos = 0;
    int64_t f = 0;
    for (; f < nframes && pos < nsamples; ++f) {
        uint8_t *frame = out + f * 64;
        uint32_t ctrl = 0;
        int wstart = (f == 0) ? 3 : 1;
        for (int w = wstart; w < WORDS_PER_FRAME && pos < nsamples; ++w) {
            int32_t d[4];
            int avail = (nsamples - pos) < 4 ? (int)(nsamples - pos) : 4;
            for (int i = 0; i < avail; ++i) {
                int32_t prev_s = (pos + i == 0) ? prev : samples[pos + i - 1];
                d[i] = samples[pos + i] - prev_s;
            }
            uint32_t word = 0;
            int nib, count;
            int fit8 = 1, fit16 = 1;
            for (int i = 0; i < avail && i < 4; ++i)
                if (d[i] < -128 || d[i] > 127) { fit8 = 0; break; }
            for (int i = 0; i < avail && i < 2; ++i)
                if (d[i] < -32768 || d[i] > 32767) { fit16 = 0; break; }
            if (avail >= 4 && fit8) {
                nib = 1; count = 4;
                for (int i = 0; i < 4; ++i)
                    word |= ((uint32_t)d[i] & 0xFF) << (8 * (3 - i));
            } else if (avail >= 2 && fit16) {
                nib = 2; count = 2;
                for (int i = 0; i < 2; ++i)
                    word |= ((uint32_t)d[i] & 0xFFFF) << (16 * (1 - i));
            } else {
                nib = 3; count = 1;
                word = (uint32_t)d[0];
            }
            put_be32(frame + 4 * w, word);
            ctrl |= (uint32_t)nib << (2 * (WORDS_PER_FRAME - 1 - w));
            pos += count;
        }
        put_be32(frame, ctrl);
    }
    put_be32(out + 4, (uint32_t)samples[0]);
    put_be32(out + 8, (uint32_t)samples[pos - 1]);
    *frames_used = f;
    return pos;
}

/*
 * steim_decode_records: decode a batch of same-geometry records in one
 * call (the per-record ctypes round-trip dominates day-file reads from
 * Python). Record r's frames start at buf + offsets[r] + data_offset and
 * span (reclen - data_offset) bytes; enc[r] is the SEED encoding code
 * (10 = STEIM1, 11 = STEIM2; a STEIM2 file may contain per-record STEIM1
 * fallbacks). Exactly npts[r] samples are appended to `out` per record.
 *
 * Returns the total samples written, or -(r+1) if record r was malformed
 * or yielded fewer than npts[r] samples (caller falls back to the
 * per-record path, which logs and skips the bad record).
 */
int64_t steim_decode_records(const uint8_t *buf, const int64_t *offsets,
                             const int64_t *npts, const uint8_t *enc,
                             int64_t n_records, int64_t data_offset,
                             int64_t reclen, int swapflag, int32_t *out) {
    int64_t nframes = (reclen - data_offset) / 64;
    int64_t total = 0;
    for (int64_t r = 0; r < n_records; ++r) {
        const uint8_t *frames = buf + offsets[r] + data_offset;
        int64_t n;
        if (enc[r] == 11) {
            n = steim2_decode(frames, nframes, npts[r], out + total,
                              swapflag);
        } else if (enc[r] == 10) {
            n = steim1_decode(frames, nframes, npts[r], out + total,
                              swapflag);
        } else {
            return -(r + 1);
        }
        if (n != npts[r]) return -(r + 1);
        total += n;
    }
    return total;
}

/*
 * steim_encode_records: pack a whole sample array into consecutive
 * records' frame payloads in one call. out_frames holds max_records
 * payloads of nframes*64 bytes each. encoding 11 tries STEIM2 per record
 * and falls back to STEIM1 when a difference overflows 30 bits;
 * encoding 10 is pure STEIM1. consumed[r] / rec_enc[r] receive each
 * record's sample count and actual encoding.
 *
 * Returns the number of records produced (all samples consumed), or -1
 * if max_records was too small.
 */
int64_t steim_encode_records(const int32_t *samples, int64_t nsamples,
                             int64_t nframes, int encoding,
                             uint8_t *out_frames, int64_t max_records,
                             int64_t *consumed, uint8_t *rec_enc) {
    int64_t pos = 0;
    int64_t r = 0;
    int64_t frame_bytes = nframes * 64;
    while (pos < nsamples) {
        if (r >= max_records) return -1;
        uint8_t *dst = out_frames + r * frame_bytes;
        int32_t prev = pos > 0 ? samples[pos - 1] : samples[pos];
        int64_t used;
        int64_t n = -1;
        uint8_t e = (uint8_t)(encoding == 11 ? 11 : 10);
        if (e == 11) {
            n = steim2_encode(samples + pos, nsamples - pos, prev, dst,
                              nframes, &used);
        }
        if (n < 0 || e == 10) {
            e = 10;
            n = steim1_encode(samples + pos, nsamples - pos, prev, dst,
                              nframes, &used);
        }
        if (n <= 0) return -1; /* cannot happen: steim1 always advances */
        consumed[r] = n;
        rec_enc[r] = e;
        pos += n;
        ++r;
    }
    return r;
}
