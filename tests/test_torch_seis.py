# -*- coding: utf-8 -*-
"""
The port's seismic data layer (quakemigrate_torch.seis and the resampling
chain of quakemigrate_torch.util) against the JAX package's:

- UTCDateTime parsing, arithmetic and calendar fields, exactly (the
  window bounds of detect must agree to the nanosecond);
- the STEIM1/2 codec (the port's own build of the C codec) bit-equal to
  quakemigrate_tpu.core, including the STEIM2 -> STEIM1 fallback;
- the synthetic archive the JAX package writes, read sample-identical by
  the port; miniSEED the port writes (STEIM2, INT32, FLOAT32, FLOAT64)
  byte-identical to the JAX writer's and read sample-identical by
  quakemigrate_tpu.seis.read;
- detrend, taper, bandpass filter, decimate, resample, interpolate,
  merge and trim at 1e-12 (float64).

"""

import numpy as np
import pytest

from quakemigrate_tpu import core as j_core
from quakemigrate_tpu import seis as j_seis
from quakemigrate_tpu import util as j_util
from quakemigrate_torch import seis, util
from quakemigrate_torch.seis import steim

import torch_synthetic as ws

RTOL = 1e-12

TIMES = [
    "2021-02-18T12:00:20.0", "2021-02-18T23:59:59.999999999",
    "2014-06-29T18:42:05.004", "2016-02-29", "2014-180T01:02:03.5",
    "20140629T184205.25Z", "1999-12-31 23:59:59.123456", 1.5e9, 0,
]


@pytest.mark.parametrize("value", TIMES)
def test_utcdatetime_parsing_and_fields(value):
    got, ref = seis.UTCDateTime(value), j_seis.UTCDateTime(value)
    assert got.ns == ref.ns
    assert str(got) == str(ref)
    for field in ("year", "julday", "month", "day", "hour", "minute",
                  "second", "microsecond", "nanosecond", "date"):
        assert getattr(got, field) == getattr(ref, field), field


@pytest.mark.parametrize("step", [2.5, 0.004, 120.0, 1 / 3, 86400.0])
def test_utcdatetime_window_arithmetic(step):
    """The detect window bounds, to the nanosecond."""

    start, ref = (m.UTCDateTime("2021-02-18T12:00:20.0") for m in
                  (seis, j_seis))
    for i in range(7):
        got = start + step * i - 1.65
        want = ref + step * i - 1.65
        assert got.ns == want.ns
        got_end = start + step * (i + 1) - 1 / 250 + 4.0
        want_end = ref + step * (i + 1) - 1 / 250 + 4.0
        assert got_end.ns == want_end.ns
        assert (got_end - got) == (want_end - want)
    assert seis.UTCDateTime(year=2021, julday=49).ns == (
        j_seis.UTCDateTime(year=2021, julday=49).ns)


def _samples(kind, n=3000, seed=7):
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        return np.round(1e4 * np.sin(np.arange(n) / 13.0)
                        + rng.normal(0, 30, n)).astype(np.int32)
    if kind == "wide":  # differences overflow 30 bits: STEIM2 -> STEIM1
        x = rng.integers(-2**30, 2**30, n).astype(np.int32)
        x[::7] = np.int32(2**31 - 1)
        return x
    return rng.integers(-50, 50, n).astype(np.int32)


@pytest.mark.parametrize("kind", ["smooth", "wide", "small"])
@pytest.mark.parametrize("encoding", [10, 11])
def test_steim_records_bit_equal(kind, encoding):
    x = _samples(kind)
    got = steim.steim_encode_records(x, 7, encoding)
    ref = j_core.steim_encode_records(x, 7, encoding)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    if kind == "wide" and encoding == 11:
        assert (got[2] == 10).any()  # the STEIM1 fallback ran
    payloads, consumed, rec_enc = got
    buf = np.concatenate([np.zeros((len(payloads), 64), np.uint8), payloads],
                         axis=1).ravel().tobytes()
    reclen = 64 + payloads.shape[1]
    offsets = np.arange(len(payloads)) * reclen
    decoded = steim.steim_decode_records(buf, offsets, consumed, rec_enc, 64,
                                         reclen)
    np.testing.assert_array_equal(decoded, x)
    np.testing.assert_array_equal(decoded, j_core.steim_decode_records(
        buf, offsets, consumed, rec_enc, 64, reclen))


@pytest.mark.parametrize("encoding", [10, 11])
def test_steim_single_frames_bit_equal(encoding):
    x = _samples("smooth", 500)
    n, frames = steim.steim_encode(x, x[0], 4, encoding)
    assert (n, frames) == j_core.steim_encode(x, x[0], 4, encoding)
    np.testing.assert_array_equal(
        steim.steim_decode(frames, n, encoding), x[:n])
    with pytest.raises(ValueError):
        steim.steim_decode(frames, n + 1000, encoding)


def test_steim2_overflow_raises_as_reference():
    x = _samples("wide", 200)
    with pytest.raises(ValueError):
        steim.steim_encode(x, x[0], 7, 11)
    with pytest.raises(ValueError):
        j_core.steim_encode(x, x[0], 7, 11)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return ws.build_workspace(tmp_path_factory.mktemp("torch_seis"))


def _assert_streams_equal(got, ref):
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a.id == b.id
        assert a.stats.starttime.ns == b.stats.starttime.ns
        assert a.stats.sampling_rate == b.stats.sampling_rate
        assert a.data.dtype == b.data.dtype
        np.testing.assert_array_equal(a.data, b.data)


def test_jax_archive_reads_sample_identical(workspace):
    files = sorted(workspace["archive"].rglob("*.m"))
    assert len(files) == 3 * ws.N_STATIONS
    for path in files:
        _assert_streams_equal(seis.read(path), j_seis.read(str(path)))
    # windowed reads, twice (the second through the record index)
    start = "2021-02-18T12:00:18.35"
    end = "2021-02-18T12:00:27.5"
    for _ in range(2):
        for path in files[:4]:
            _assert_streams_equal(
                seis.read(path, starttime=seis.UTCDateTime(start),
                          endtime=seis.UTCDateTime(end)),
                j_seis.read(str(path), starttime=j_seis.UTCDateTime(start),
                            endtime=j_seis.UTCDateTime(end)))


def _pair(data, start="2021-02-18T23:59:50.123456", rate=100.0):
    header = {"network": "SC", "station": "ST01", "channel": "CHZ",
              "sampling_rate": rate}
    port = seis.Trace(data.copy(), {**header,
                                    "starttime": seis.UTCDateTime(start)})
    ref = j_seis.Trace(data.copy(), {**header,
                                     "starttime": j_seis.UTCDateTime(start)})
    return port, ref


@pytest.mark.parametrize("encoding,dtype", [
    ("STEIM2", np.int32), ("STEIM1", np.int32), ("INT32", np.int32),
    ("FLOAT32", np.float32), ("FLOAT64", np.float64),
])
def test_port_written_mseed_reads_identical(tmp_path, encoding, dtype):
    rng = np.random.default_rng(3)
    data = rng.normal(0, 1e3, 4000)
    if dtype is np.int32:
        data = np.round(data)
        data[100] = 2**30  # one STEIM2 -> STEIM1 record
    data = data.astype(dtype)
    port, ref = _pair(data)
    port.write(str(tmp_path / "port.mseed"), format="MSEED",
               encoding=encoding)
    ref.write(str(tmp_path / "jax.mseed"), format="MSEED", encoding=encoding)
    assert (tmp_path / "port.mseed").read_bytes() == (
        tmp_path / "jax.mseed").read_bytes()
    back = j_seis.read(str(tmp_path / "port.mseed"))
    assert len(back) == 1
    np.testing.assert_array_equal(back[0].data, data)
    assert back[0].stats.starttime.ns == ref.stats.starttime.ns
    _assert_streams_equal(seis.read(tmp_path / "port.mseed"), back)


def _trace_pair(seed=5, n=2500, rate=100.0):
    rng = np.random.default_rng(seed)
    data = np.cumsum(rng.normal(size=n)) + 3.0 * np.sin(np.arange(n) / 5.0)
    return _pair(data, start="2021-02-18T12:00:00.0", rate=rate)


PROCESSING = {
    "detrend_linear": lambda t: t.detrend("linear"),
    "detrend_demean": lambda t: t.detrend("demean"),
    "detrend_simple": lambda t: t.detrend("simple"),
    "taper": lambda t: t.taper(max_percentage=0.05, type="cosine"),
    "bandpass": lambda t: t.filter("bandpass", freqmin=1.0, freqmax=12.0,
                                   corners=2, zerophase=True),
    "bandpass_causal": lambda t: t.filter("bandpass", freqmin=2.0,
                                          freqmax=16.0, corners=4),
    "lowpass": lambda t: t.filter("lowpass", freq=20.0, corners=2,
                                  zerophase=True),
    "highpass": lambda t: t.filter("highpass", freq=1.0, corners=2),
    "decimate": lambda t: t.decimate(4),
    "resample": lambda t: t.resample(40.0),
    "interpolate": lambda t: t.interpolate(
        100.0, method="lanczos", a=20,
        starttime=t.stats.starttime + 1.003),
    "trim": lambda t: t.trim(t.stats.starttime + 1.234,
                             t.stats.starttime + 20.0),
    "trim_pad": lambda t: t.trim(t.stats.starttime - 1.0,
                                 t.stats.starttime + 40.0, pad=True,
                                 fill_value=0.5),
    "util_decimate": lambda t: (util if isinstance(t, seis.Trace)
                                else j_util).decimate(t, 25),
}


@pytest.mark.parametrize("name", sorted(PROCESSING))
def test_trace_processing_matches(name):
    port, ref = _trace_pair()
    got, want = PROCESSING[name](port), PROCESSING[name](ref)
    got = port if got is None else got
    want = ref if want is None else want
    assert got.stats.starttime.ns == want.stats.starttime.ns
    assert got.stats.sampling_rate == want.stats.sampling_rate
    assert got.data.shape == want.data.shape
    np.testing.assert_allclose(got.data, want.data, rtol=RTOL, atol=1e-12)


def _segments(module):
    start = module.UTCDateTime("2021-02-18T12:00:00.0")
    data = np.arange(1000, dtype=np.int32)
    header = {"network": "SC", "station": "ST01", "channel": "CHZ",
              "sampling_rate": 100.0}
    pieces = [(0, 400), (400, 700), (650, 800), (850, 1000)]  # overlap, gap
    return module.Stream([
        module.Trace(data[a:b].copy(),
                     {**header, "starttime": start + a / 100.0})
        for a, b in pieces
    ])


@pytest.mark.parametrize("method,fill", [(-1, None), (1, None), (1, 7)])
def test_merge_and_gaps_match(method, fill):
    got = _segments(seis).merge(method=method, fill_value=fill)
    want = _segments(j_seis).merge(method=method, fill_value=fill)
    _assert_streams_equal(got, want)
    assert [r[6] for r in _segments(seis).get_gaps()] == [
        r[6] for r in _segments(j_seis).get_gaps()]


def test_merge_stream_and_resample_chain_match(workspace):
    files = sorted(workspace["archive"].rglob("ST0[12]*.m"))
    got = seis.Stream()
    want = j_seis.Stream()
    for path in files:
        got += seis.read(path)
        want += j_seis.read(str(path))
    got, want = util.merge_stream(got), j_util.merge_stream(want)
    _assert_streams_equal(got, want)
    s0, s1 = (seis.UTCDateTime("2021-02-18T12:00:10.0"),
              seis.UTCDateTime("2021-02-18T12:00:30.0"))
    r0, r1 = (j_seis.UTCDateTime("2021-02-18T12:00:10.0"),
              j_seis.UTCDateTime("2021-02-18T12:00:30.0"))
    for rate in (50, 25):
        a = util.resample(got, rate, False, None, s0, s1)
        b = j_util.resample(want, rate, False, None, r0, r1)
        assert len(a) == len(b) == len(got)
        for x, y in zip(a, b):
            assert x.stats.starttime.ns == y.stats.starttime.ns
            np.testing.assert_allclose(x.data, y.data, rtol=RTOL,
                                       atol=1e-12)
