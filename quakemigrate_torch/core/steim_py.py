# -*- coding: utf-8 -*-
"""
Pure-Python STEIM1/2 codec: the same frames as the port's C codec
(``csrc/host/steimlib.c``, :mod:`quakemigrate_torch.seis.steim`), word
for word; slow but needs no compiler. ``decode`` fills ``out`` and
returns the samples decoded (-1 on a malformed word); ``encode`` fills
``out`` with frames and returns (samples consumed, frames used), or (-1,
0) where a STEIM2 difference overflows 30 bits.

"""

import numpy as np


def _sext(v, bits):
    m = 1 << (bits - 1)
    v &= (1 << bits) - 1
    return (v ^ m) - m


def decode(frames, nframes, max_samples, out, encoding,
           little_endian=False):
    dtype = "<u4" if little_endian else ">u4"
    words = np.frombuffer(bytes(frames[: nframes * 64]), dtype=dtype).reshape(
        nframes, 16
    )
    n = 0
    x0 = None
    last = 0
    for f in range(nframes):
        ctrl = int(words[f, 0])
        for w in range(1, 16):
            nib = (ctrl >> (2 * (15 - w))) & 3
            word = int(words[f, w])
            if f == 0 and w == 1:
                x0 = _sext(word, 32)
                continue
            if f == 0 and w == 2:
                continue
            if nib == 0:
                continue
            diffs = []
            if nib == 1:
                diffs = [_sext(word >> (8 * (3 - i)), 8) for i in range(4)]
            elif encoding == 11:
                if nib == 2:
                    dnib = word >> 30
                    if dnib == 1:
                        diffs = [_sext(word, 30)]
                    elif dnib == 2:
                        diffs = [_sext(word >> (15 * (1 - i)), 15) for i in range(2)]
                    elif dnib == 3:
                        diffs = [_sext(word >> (10 * (2 - i)), 10) for i in range(3)]
                    else:
                        return -1
                else:
                    dnib = word >> 30
                    if dnib == 0:
                        diffs = [_sext(word >> (6 * (4 - i)), 6) for i in range(5)]
                    elif dnib == 1:
                        diffs = [_sext(word >> (5 * (5 - i)), 5) for i in range(6)]
                    elif dnib == 2:
                        diffs = [_sext(word >> (4 * (6 - i)), 4) for i in range(7)]
                    else:
                        return -1
            else:  # STEIM1
                if nib == 2:
                    diffs = [_sext(word >> (16 * (1 - i)), 16) for i in range(2)]
                else:
                    diffs = [_sext(word, 32)]
            for d in diffs:
                if n >= max_samples:
                    break
                if n == 0:
                    last = x0 if x0 is not None else d
                else:
                    # int32 wraparound, mirroring the C accumulator
                    # (steimlib.c:112's int32_t `last`)
                    last = _sext(last + d, 32)
                out[n] = last
                n += 1
    return n


def _bits2(d):
    for bits, lim in ((4, 8), (5, 16), (6, 32), (8, 128), (10, 512), (15, 16384)):
        if -lim <= d < lim:
            return bits
    if -(1 << 29) <= d < (1 << 29):
        return 30
    return 32


def encode(samples, prev, out, nframes, encoding):
    samples = np.asarray(samples, dtype=np.int64)
    n_in = len(samples)
    if nframes <= 0 or n_in == 0:
        return 0, 0
    prevs = np.concatenate([[prev], samples[:-1]])
    # int32 wraparound differences, mirroring the C encoder
    # (steimlib.c:190-191 computes d in int32_t)
    raw = (samples - prevs) & 0xFFFFFFFF
    diffs = ((raw ^ 0x80000000) - 0x80000000).astype(np.int64)

    words_out = np.zeros((nframes, 16), dtype=np.uint64)
    pos = 0
    f = 0
    while f < nframes and pos < n_in:
        ctrl = 0
        wstart = 3 if f == 0 else 1
        for w in range(wstart, 16):
            if pos >= n_in:
                break
            avail = min(7, n_in - pos)
            d = diffs[pos : pos + avail]
            word = 0
            if encoding == 11:
                bc = [_bits2(int(x)) for x in d]
                if avail >= 7 and max(bc[:7]) <= 4:
                    nib, count = 3, 7
                    word = 2 << 30
                    for i in range(7):
                        word |= (int(d[i]) & 0xF) << (4 * (6 - i))
                elif avail >= 6 and max(bc[:6]) <= 5:
                    nib, count = 3, 6
                    word = 1 << 30
                    for i in range(6):
                        word |= (int(d[i]) & 0x1F) << (5 * (5 - i))
                elif avail >= 5 and max(bc[:5]) <= 6:
                    nib, count = 3, 5
                    for i in range(5):
                        word |= (int(d[i]) & 0x3F) << (6 * (4 - i))
                elif avail >= 4 and max(bc[:4]) <= 8:
                    nib, count = 1, 4
                    for i in range(4):
                        word |= (int(d[i]) & 0xFF) << (8 * (3 - i))
                elif avail >= 3 and max(bc[:3]) <= 10:
                    nib, count = 2, 3
                    word = 3 << 30
                    for i in range(3):
                        word |= (int(d[i]) & 0x3FF) << (10 * (2 - i))
                elif avail >= 2 and max(bc[:2]) <= 15:
                    nib, count = 2, 2
                    word = 2 << 30
                    for i in range(2):
                        word |= (int(d[i]) & 0x7FFF) << (15 * (1 - i))
                elif bc[0] <= 30:
                    nib, count = 2, 1
                    word = (1 << 30) | (int(d[0]) & 0x3FFFFFFF)
                else:
                    return -1, 0
            else:  # STEIM1
                fit8 = avail >= 4 and all(-128 <= int(x) < 128 for x in d[:4])
                fit16 = avail >= 2 and all(-32768 <= int(x) < 32768 for x in d[:2])
                if fit8:
                    nib, count = 1, 4
                    for i in range(4):
                        word |= (int(d[i]) & 0xFF) << (8 * (3 - i))
                elif fit16:
                    nib, count = 2, 2
                    for i in range(2):
                        word |= (int(d[i]) & 0xFFFF) << (16 * (1 - i))
                else:
                    nib, count = 3, 1
                    word = int(d[0]) & 0xFFFFFFFF
            words_out[f, w] = word
            ctrl |= nib << (2 * (15 - w))
            pos += count
        words_out[f, 0] = ctrl
        f += 1

    words_out[0, 1] = int(samples[0]) & 0xFFFFFFFF
    words_out[0, 2] = int(samples[pos - 1]) & 0xFFFFFFFF
    packed = words_out.astype(">u4").tobytes()
    out[: len(packed)] = np.frombuffer(packed, dtype=np.uint8)
    return pos, f
