"""Port parity: the data substrate against the JAX package's copy.

The port keeps its own numpy-only copies of ``repro.data.dataset``
(``split_of``, ``Dataset``), ``repro.data.ingest`` and
``repro.data.pipeline``.  The same samples give the same ids, splits,
version hashes and manifests; the same bytes the same ingested samples;
the same seed, epoch, host index and host count the same batches.  Also
the invariants of ``tests/test_data.py`` on the port's side.
"""
import hashlib
import io
import json
import wave

import numpy as np
import pytest

from repro.data import dataset as jds
from repro.data import ingest as jing
from repro.data import pipeline as jpipe
from repro_torch.data import dataset as tds
from repro_torch.data import ingest as ting
from repro_torch.data import pipeline as tpipe
from repro_torch.data import synthetic as tsyn


def _samples(seed=0, n_per_class=4):
    return tsyn.keyword_audio(n_per_class=n_per_class, n_classes=2,
                              n_samples=800, seed=seed)


def _jax_samples(samples):
    return [jds.Sample(s.data, s.label, dict(s.metadata), s.sample_id)
            for s in samples]


def test_split_of_matches_jax():
    ids = [hashlib.sha1(str(i).encode()).hexdigest() for i in range(2000)]
    for kw in ({}, {"val_frac": 0.25, "test_frac": 0.05}):
        got = [tds.split_of(i, **kw) for i in ids]
        assert got == [jds.split_of(i, **kw) for i in ids]
        assert set(got) == {"train", "val", "test"}


def test_sample_ids_match_jax():
    for s in _samples():
        j = jds.Sample(s.data, s.label, dict(s.metadata))
        assert tds.Sample(s.data, s.label).sample_id == j.sample_id


def test_dataset_commit_and_checkout_match_jax(tmp_path):
    samples = _samples()
    tstore = tds.Dataset(tmp_path / "port")
    jstore = jds.Dataset(tmp_path / "jax")
    assert tstore.add_many(samples) == jstore.add_many(_jax_samples(samples))
    v1 = tstore.commit("initial")
    assert v1 == jstore.commit("initial")
    removed = next(iter(tstore.samples))
    tstore.remove(removed)
    jstore.remove(removed)
    v2 = tstore.commit("removed one")
    assert v2 == jstore.commit("removed one") and v2 != v1
    assert tstore.versions() == jstore.versions() == sorted([v1, v2])
    for v in (v1, v2):
        got = json.loads((tmp_path / "port" / "versions" / f"{v}.json")
                         .read_text())
        want = json.loads((tmp_path / "jax" / "versions" / f"{v}.json")
                          .read_text())
        got.pop("time"), want.pop("time")
        assert got == want
    old, new = tstore.checkout(v1), tstore.checkout(v2)
    assert len(old) == len(samples) and removed in old.samples
    assert removed not in new.samples
    jold = jstore.checkout(v1)
    for sid, s in old.samples.items():
        np.testing.assert_array_equal(s.data, jold.samples[sid].data)
        assert (s.label, s.metadata) == (jold.samples[sid].label,
                                         jold.samples[sid].metadata)


def test_dataset_splits_and_arrays_match_jax():
    samples = _samples(seed=3, n_per_class=20)
    tstore, jstore = tds.Dataset(), jds.Dataset()
    tstore.add_many(samples)
    jstore.add_many(_jax_samples(samples))
    for name in ("train", "val", "test"):
        assert [s.sample_id for s in tstore.split(name)] == \
            [s.sample_id for s in jstore.split(name)]
        tx, ty = tstore.arrays(name)
        jx, jy = jstore.arrays(name)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        assert ty.dtype == jy.dtype
    assert tstore.class_counts() == jstore.class_counts()
    assert tstore.versions() == [] and len(tstore) == 40
    with pytest.raises(ValueError, match="rooted"):
        tstore.checkout("abc")


def test_split_stability_under_additions():
    """Adding samples never moves existing samples across splits."""
    samples = _samples(seed=0, n_per_class=10)
    before = {s.sample_id: tds.split_of(s.sample_id) for s in samples}
    more = _samples(seed=9, n_per_class=10)
    after = {s.sample_id: tds.split_of(s.sample_id) for s in samples + more}
    for sid, sp in before.items():
        assert after[sid] == sp


def _wav_bytes(sig, width=2, rate=16000):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(sig.tobytes())
    return buf.getvalue()


def _npy_bytes(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


_SIG = (np.sin(np.linspace(0, 40, 1600)) * 2 ** 14).astype(np.int16)
# format: (ingestor name, payload, positional arguments after the payload)
PAYLOADS = {
    "csv": ("ingest_csv", b"# header\n1.0,2.0\n3.0,4.0\n5.5,-1\n", (1,)),
    "csv_one_channel": ("ingest_csv", b"0.5\n0.25\n-2\n", (0,)),
    "json": ("ingest_json", json.dumps({"values": [0.1, 0.2, 0.3],
                                        "label": 2,
                                        "device": "nano"}).encode(), ()),
    "wav": ("ingest_wav", _wav_bytes(_SIG), (0,)),
    "npy": ("ingest_npy", _npy_bytes(np.arange(12.0).reshape(3, 4)), (3,)),
}


def _same(got, want):
    np.testing.assert_array_equal(got.data, want.data)
    assert got.data.dtype == want.data.dtype
    assert (got.label, got.metadata, got.sample_id) == \
        (want.label, want.metadata, want.sample_id)


@pytest.mark.parametrize("fmt", sorted(PAYLOADS))
def test_ingestors_match_jax(fmt, tmp_path):
    """From bytes and from a file of the same bytes."""
    fn, payload, args = PAYLOADS[fmt]
    _same(getattr(ting, fn)(payload, *args), getattr(jing, fn)(payload, *args))
    path = tmp_path / f"x.{fmt.split('_')[0]}"
    path.write_bytes(payload)
    meta = {"path": "p"}
    _same(getattr(ting, fn)(path, *args, metadata=meta),
          getattr(jing, fn)(path, *args, metadata=meta))


def test_ingest_directory_matches_jax(tmp_path):
    for label, files in ((0, {"a.wav": _wav_bytes(_SIG),
                              "b.npy": _npy_bytes(np.ones(5))}),
                         (1, {"c.csv": b"1,2\n3,4\n", "skip.txt": b"no",
                              "d.json": json.dumps(
                                  {"values": [1, 2], "label": 1}).encode()})):
        sub = tmp_path / f"{label}_class"
        sub.mkdir()
        for name, payload in files.items():
            (sub / name).write_bytes(payload)
    for by_dir in (True, False):
        got = ting.ingest_directory(tmp_path, label_from_dir=by_dir)
        want = jing.ingest_directory(tmp_path, label_from_dir=by_dir)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            _same(a, b)
    assert sorted(ting.INGESTORS) == sorted(jing.INGESTORS)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False),
                                               (False, False)])
def test_batch_pipeline_matches_jax(shuffle, drop_last):
    xs = np.arange(70 * 3, dtype=np.float32).reshape(70, 3)
    ys = np.arange(70).astype(np.int32)
    for hosts in (1, 2, 4):
        for host in range(hosts):
            kw = dict(batch_size=16, shuffle=shuffle, seed=3,
                      drop_last=drop_last, host_index=host, host_count=hosts)
            got = tpipe.BatchPipeline({"x": xs, "y": ys}, **kw)
            want = jpipe.BatchPipeline({"x": xs, "y": ys}, **kw)
            for ep in (0, 1):
                a, b = list(got.epoch(ep)), list(want.epoch(ep))
                assert len(a) == len(b) > 0
                for ba, bb in zip(a, b):
                    for k in ("x", "y"):
                        np.testing.assert_array_equal(ba[k], bb[k])
            it = got.forever()
            first = [next(it)["y"] for _ in range(len(a) + 1)]
            np.testing.assert_array_equal(first[-1],
                                          next(got.epoch(1))["y"])
    with pytest.raises(ValueError):
        tpipe.BatchPipeline({"x": xs}, batch_size=10, host_count=4)
    with pytest.raises(ValueError):
        tpipe.BatchPipeline({"x": xs, "y": ys[:5]}, batch_size=8)


def test_pipeline_host_sharding():
    xs = np.arange(64)[:, None].astype(np.float32)
    ys = np.arange(64).astype(np.int32)
    got = []
    for host in range(4):
        p = tpipe.BatchPipeline({"x": xs, "y": ys}, batch_size=16,
                                shuffle=True, seed=3, host_index=host,
                                host_count=4)
        got.append([b["y"] for b in p.epoch(0)])
    for step in range(len(got[0])):
        union = np.concatenate([got[h][step] for h in range(4)])
        assert len(set(union.tolist())) == 16


def test_prefetcher_preserves_order():
    out = [b["i"] for b in tpipe.Prefetcher(iter([{"i": i}
                                                   for i in range(10)]),
                                            depth=3)]
    assert out == list(range(10))
    doubled = tpipe.Prefetcher(iter(range(7)), depth=1,
                               transform=lambda x: 2 * x)
    assert list(doubled) == list(jpipe.Prefetcher(
        iter(range(7)), depth=1, transform=lambda x: 2 * x))
    doubled.thread.join(5)
    assert not doubled.thread.is_alive()
