"""The reference's data preparation in the port (``deepfm_tpu_torch.data.
libsvm``, ``data.criteo`` and the native Criteo hash encoder) against the
JAX package's on the same inputs, made from a seed: the shards must be
byte-equal, not just hold equal records, on both of the port's routes (the
C++ encoder, and ``DEEPFM_NO_NATIVE=1``'s Python encoder) against both of
JAX's."""

import hashlib
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from deepfm_tpu.data import criteo as jax_criteo
from deepfm_tpu.data import libsvm as jax_libsvm
from deepfm_tpu_torch import native
from deepfm_tpu_torch.data import criteo, libsvm
from deepfm_tpu_torch.data.tfrecord import read_records, write_records

ROOT = Path(__file__).resolve().parent.parent
FEATURES = 20_000


def _synthetic_tsv(path, n=200, seed=0, crlf_every=0):
    """Raw Criteo lines with the missingness of tests/test_criteo.py, a few
    negative integers and, every ``crlf_every`` lines, a CRLF ending."""
    rng = random.Random(seed)
    toks = [f"{rng.getrandbits(32):08x}" for _ in range(30)]
    with open(path, "w", newline="") as f:
        for i in range(n):
            ints = ["" if rng.random() < 0.3 else str(rng.randrange(-3, 5000))
                    for _ in range(13)]
            cats = ["" if rng.random() < 0.2 else rng.choice(toks) for _ in range(26)]
            end = "\r\n" if crlf_every and i % crlf_every == 0 else "\n"
            f.write("\t".join([str(int(rng.random() < 0.25))] + ints + cats) + end)
    return path


def _bytes(paths) -> list[bytes]:
    return [Path(p).read_bytes() for p in paths]


def _names(paths) -> list[str]:
    return [os.path.basename(p) for p in paths]


# -- libsvm ------------------------------------------------------------------

SAMPLE = "1 1:0.5 2:0.03519 3:1 4:0.02567 7:0.03708\n\n0 5:1.0 9:0.25\n1 3:-2.5e-3 8:7\n"


@pytest.mark.parametrize("pad", [None, 8], ids=["as-is", "pad-8"])
def test_libsvm_to_tfrecord_bytes_match_jax(tmp_path, pad):
    src = tmp_path / "tr.libsvm"
    src.write_text(SAMPLE)
    mine, theirs = tmp_path / "port.tfrecords", tmp_path / "jax.tfrecords"
    assert libsvm.libsvm_to_tfrecord(src, mine, pad_to_field_size=pad) == 3
    assert jax_libsvm.libsvm_to_tfrecord(src, theirs, pad_to_field_size=pad) == 3
    assert mine.read_bytes() == theirs.read_bytes()


def test_a_line_longer_than_the_pad_raises_as_in_jax(tmp_path):
    src = tmp_path / "tr.libsvm"
    src.write_text(SAMPLE)
    with pytest.raises(ValueError, match="features > field_size 4"):
        libsvm.libsvm_to_tfrecord(src, tmp_path / "a", pad_to_field_size=4)
    with pytest.raises(ValueError, match="features > field_size 4"):
        jax_libsvm.libsvm_to_tfrecord(src, tmp_path / "b", pad_to_field_size=4)
    # the input opens first: a missing input leaves no output behind
    with pytest.raises(FileNotFoundError):
        libsvm.libsvm_to_tfrecord(tmp_path / "missing", tmp_path / "c")
    assert not (tmp_path / "c").exists()


def test_tfrecord_to_libsvm_lines_match_jax(tmp_path):
    path = tmp_path / "syn.tfrecords"
    libsvm.generate_synthetic_ctr(path, num_records=40, feature_size=1000, seed=3)
    got = list(libsvm.tfrecord_to_libsvm(path))
    assert got == list(jax_libsvm.tfrecord_to_libsvm(path))
    assert len(got) == 40 and got[0].split()[1].startswith("1:")


def test_write_records_bytes_match_jax(tmp_path):
    from deepfm_tpu.data.tfrecord import write_records as jax_write_records

    records = [bytes(range(n % 256)) * (n % 7 + 1) for n in range(50)]
    write_records(tmp_path / "a", records)
    jax_write_records(tmp_path / "b", records)
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    assert list(read_records(tmp_path / "a")) == records


def _module(name: str, *args: str) -> subprocess.CompletedProcess:
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, "-m", name, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


def test_the_libsvm_cli_both_ways_matches_jax(tmp_path):
    src = tmp_path / "in.libsvm"
    src.write_text("1 1:0.5 14:1\n0 2:0.3 20:1\n")
    out = {}
    for pkg in ("deepfm_tpu_torch", "deepfm_tpu"):
        rec, back = tmp_path / f"{pkg}.tfrecords", tmp_path / f"{pkg}.libsvm"
        r = _module(f"{pkg}.data.libsvm", str(src), str(rec), "--pad-to-field-size", "3")
        assert r.returncode == 0, r.stderr
        fwd = json.loads(r.stdout)
        r = _module(f"{pkg}.data.libsvm", "--reverse", str(rec), str(back))
        assert r.returncode == 0, r.stderr
        out[pkg] = (fwd, json.loads(r.stdout), rec.read_bytes(), back.read_text())
    port, jax = out["deepfm_tpu_torch"], out["deepfm_tpu"]
    assert port[0] == {"records": 2, "output": str(tmp_path / "deepfm_tpu_torch.tfrecords")}
    assert port[1]["records"] == jax[1]["records"] == 2
    assert port[2:] == jax[2:]
    assert port[3].splitlines() == ["1 1:0.5 14:1 0:0", "0 2:0.3 20:1 0:0"]


def test_the_libsvm_cli_refuses_a_pad_in_reverse(tmp_path):
    existing = tmp_path / "out.libsvm"
    existing.write_text("keep\n")
    r = _module("deepfm_tpu_torch.data.libsvm", "--reverse", "--pad-to-field-size", "3",
                str(tmp_path / "x.tfrecords"), str(existing))
    assert r.returncode == 2 and "libsvm->TFRecord only" in r.stderr
    # a missing input fails before the output opens
    r = _module("deepfm_tpu_torch.data.libsvm", "--reverse",
                str(tmp_path / "missing.tfrecords"), str(existing))
    assert r.returncode != 0 and existing.read_text() == "keep\n"


# -- Criteo: parsing and the encoders ------------------------------------------

@pytest.mark.parametrize("raw", ["", "0", "100", "-3", " 5 ", "7.5", "1e3", "-0"])
def test_numeric_value_matches_jax(raw):
    assert criteo.numeric_value(raw) == jax_criteo.numeric_value(raw)


def test_parse_criteo_line_matches_jax():
    line = "1\t" + "\t".join(str(i) for i in range(13)) + "\t" + "\t".join(
        f"c{j}" for j in range(26))
    assert criteo.parse_criteo_line(line) == jax_criteo.parse_criteo_line(line)
    assert criteo.parse_criteo_line(line + "\n") == jax_criteo.parse_criteo_line(line)
    for bad in ("1\t2\t3", "x\t" + "\t".join([""] * 39)):
        with pytest.raises(ValueError):
            criteo.parse_criteo_line(bad)
        with pytest.raises(ValueError):
            jax_criteo.parse_criteo_line(bad)
    assert (criteo.FIELD_SIZE, criteo.FIRST_CAT_ID) == (jax_criteo.FIELD_SIZE,
                                                        jax_criteo.FIRST_CAT_ID)


def test_hash_ids_match_jax(tmp_path):
    lines = _synthetic_tsv(tmp_path / "raw.tsv", n=300, seed=4).read_text().splitlines()
    for size in (FEATURES, 117_581):
        mine, theirs = criteo.CriteoHashEncoder(size), jax_criteo.CriteoHashEncoder(size)
        for line in lines:
            assert mine.encode(line) == theirs.encode(line)
    with pytest.raises(ValueError, match="no categorical hash space"):
        criteo.CriteoHashEncoder(40)


def test_blake2b64_matches_hashlib():
    for data in (b"", b"0:", b"5:68fd1e64", b"25:" + b"x" * 200,
                 b"7:\xf0\x9f\x8c\x8d", b"a" * 128, b"b" * 129, b"c" * 257):
        want = int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little")
        assert native.blake2b64(data) == want, data


def test_the_vocab_encoder_matches_jax(tmp_path):
    lines = _synthetic_tsv(tmp_path / "raw.tsv", n=400, seed=5).read_text().splitlines()
    lines.append("0\t" + "\t".join([""] * 13) + "\t" + "\t".join(["unseen"] * 26))
    for min_count in (1, 10):
        vocab = criteo.build_criteo_vocab(lines, min_count=min_count)
        assert vocab == jax_criteo.build_criteo_vocab(lines, min_count=min_count)
        mine, theirs = criteo.CriteoVocabEncoder(vocab), jax_criteo.CriteoVocabEncoder(vocab)
        for line in lines:
            assert mine.encode(line) == theirs.encode(line)
    # the rare tokens of the last line take each field's OOV id
    assert mine.encode(lines[-1])[1][13:] == vocab["oov"]
    assert max(max(m.values(), default=0) for m in vocab["mapping"]) < vocab["feature_size"]
    mine.save(tmp_path / "port.json")
    theirs.save(tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    back = criteo.CriteoVocabEncoder.from_json(tmp_path / "jax.json")
    assert all(back.encode(x) == mine.encode(x) for x in lines)


# -- Criteo: shards ---------------------------------------------------------------

def _convert(module, raw, out, *, no_native: bool, **kw):
    old = os.environ.pop("DEEPFM_NO_NATIVE", None)
    if no_native:
        os.environ["DEEPFM_NO_NATIVE"] = "1"
    try:
        return module.convert_criteo_to_tfrecords(raw, out, module.CriteoHashEncoder(FEATURES),
                                                  **kw)
    finally:
        os.environ.pop("DEEPFM_NO_NATIVE", None)
        if old is not None:
            os.environ["DEEPFM_NO_NATIVE"] = old


@pytest.mark.parametrize("port_python", [False, True], ids=["port-native", "port-python"])
def test_hash_shards_are_byte_equal_to_jax_on_both_routes(tmp_path, port_python):
    raw = _synthetic_tsv(tmp_path / "raw.tsv", n=500, seed=1, crlf_every=7)
    with open(raw, "a") as f:
        f.write("\n\n")  # blank lines are skipped
    mine = _convert(criteo, raw, tmp_path / "port", no_native=port_python,
                    records_per_shard=200, prefix="va")
    assert _names(mine) == [f"va-{i:05d}.tfrecords" for i in range(3)]
    for jax_python in (False, True):
        theirs = _convert(jax_criteo, raw, tmp_path / f"jax-{jax_python}",
                          no_native=jax_python, records_per_shard=200, prefix="va")
        assert _names(theirs) == _names(mine)
        assert _bytes(mine) == _bytes(theirs)
    assert sum(1 for p in mine for _ in read_records(p)) == 500


def test_the_vocab_route_is_byte_equal_to_jax(tmp_path):
    raw = _synthetic_tsv(tmp_path / "raw.tsv", n=300, seed=2)
    vocab = criteo.build_criteo_vocab(raw.read_text().splitlines(), min_count=3)
    mine = criteo.convert_criteo_to_tfrecords(raw, tmp_path / "port",
                                              criteo.CriteoVocabEncoder(vocab),
                                              records_per_shard=128)
    theirs = jax_criteo.convert_criteo_to_tfrecords(raw, tmp_path / "jax",
                                                    jax_criteo.CriteoVocabEncoder(vocab),
                                                    records_per_shard=128)
    assert _names(mine) == _names(theirs) and len(mine) == 3
    assert _bytes(mine) == _bytes(theirs)


def test_crlf_and_python_float_parity(tmp_path):
    good = "\t".join(["1"] + [" 5 "] * 13 + ["tok"] * 26)
    raw = tmp_path / "crlf.tsv"
    raw.write_bytes(("\n".join([good + "\r", good]) + "\n").encode())
    shards = [_convert(m, raw, tmp_path / f"{m.__name__}-{py}", no_native=py)
              for m in (criteo, jax_criteo) for py in (False, True)]
    assert len({tuple(_bytes(s)) for s in shards}) == 1


@pytest.mark.parametrize("bad_field", ["0x1p3", "0X2", " -0x1 ", "1\x002", "nan(1)", "NAN(x)"])
def test_strtod_extensions_reject_like_python_float(tmp_path, bad_field):
    line = "\t".join(["1"] + [bad_field] + ["5"] * 12 + ["tok"] * 26)
    raw = tmp_path / "bad.tsv"
    raw.write_bytes((line + "\n").encode())
    with pytest.raises(ValueError):
        native.criteo_hash_encode_file(raw, tmp_path / "out", feature_size=FEATURES)
    for module in (criteo, jax_criteo):
        with pytest.raises(ValueError):
            _convert(module, raw, tmp_path / "py", no_native=True)


def test_malformed_lines_raise_on_both_routes(tmp_path):
    raw = tmp_path / "bad.tsv"
    raw.write_text("1\t5\tabc\n" + "not_a_label\t1\t2\n")
    with pytest.raises(ValueError, match="malformed"):
        native.criteo_hash_encode_file(raw, tmp_path / "out", feature_size=FEATURES)
    with pytest.raises(ValueError, match="tab-separated"):
        _convert(criteo, raw, tmp_path / "py", no_native=True)
    for bad in ("\t".join(["1"] + ["5"] * 12 + ["tok"] * 26),
                "1abc\t" + "\t".join(["5"] * 13 + ["tok"] * 26)):
        raw.write_text(bad + "\n")
        with pytest.raises(ValueError):
            _convert(criteo, raw, tmp_path / "n", no_native=False)
        with pytest.raises(ValueError):
            _convert(criteo, raw, tmp_path / "p", no_native=True)


def test_a_native_open_error_raises_the_reader_error(tmp_path):
    with pytest.raises(native.NativeReaderError):
        native.criteo_hash_encode_file(tmp_path / "missing.tsv", tmp_path / "out",
                                       feature_size=FEATURES)


@pytest.mark.parametrize("no_native", [False, True], ids=["native", "python"])
def test_no_stale_shards_from_a_larger_earlier_conversion(tmp_path, no_native):
    out = tmp_path / "enc"
    big = _synthetic_tsv(tmp_path / "big.tsv", n=300)
    assert len(_convert(criteo, big, out, no_native=no_native, records_per_shard=100)) == 3
    small = _synthetic_tsv(tmp_path / "small.tsv", n=120, seed=1)
    again = _convert(criteo, small, out, no_native=no_native, records_per_shard=100)
    assert _names(again) == ["tr-00000.tfrecords", "tr-00001.tfrecords"]


def test_a_failed_encoder_build_raises_and_nothing_falls_back(tmp_path, monkeypatch):
    raw = _synthetic_tsv(tmp_path / "raw.tsv", n=20)
    broken = tmp_path / "criteo_encoder.cc"
    broken.write_text("extern \"C\" int dfm_criteo_hash_encode( {\n")
    monkeypatch.setattr(native, "ENCODER_SOURCE", str(broken))
    monkeypatch.setattr(native, "LIB", str(tmp_path / "_build" / "lib.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.delenv("DEEPFM_NO_NATIVE", raising=False)
    with pytest.raises(native.NativeBuildError, match="error"):
        criteo.convert_criteo_to_tfrecords(raw, tmp_path / "out",
                                           criteo.CriteoHashEncoder(FEATURES))
    assert not (tmp_path / "out").exists() or not list((tmp_path / "out").iterdir())
    # the Python encoder runs only when asked for
    monkeypatch.setenv("DEEPFM_NO_NATIVE", "1")
    assert len(criteo.convert_criteo_to_tfrecords(raw, tmp_path / "out",
                                                  criteo.CriteoHashEncoder(FEATURES))) == 1


def test_a_library_older_than_the_encoder_source_is_rebuilt(tmp_path):
    """A library built before the encoder joined it has no encoder symbol:
    its mtime is older than the new source, so it is rebuilt, not loaded."""
    src = tmp_path / "extra.cc"
    src.write_text('extern "C" int dfm_extra() { return 7; }\n')
    lib = str(tmp_path / "lib.so")
    assert native.build([native.SOURCE], lib) > 0
    assert native.build([native.SOURCE], lib) == 0.0
    os.utime(src, (os.path.getmtime(lib) + 5,) * 2)
    assert native.build([native.SOURCE, str(src)], lib) > 0
    import ctypes

    assert ctypes.CDLL(lib).dfm_extra() == 7


def test_the_criteo_cli_matches_jax_and_feeds_the_train_task(tmp_path, capsys):
    """``python -m deepfm_tpu_torch.data.criteo`` writes JAX's shards and
    JSON line, and its output trains through the port's train task on the
    CPU (96 records / 32 = 3 steps)."""
    raw = _synthetic_tsv(tmp_path / "raw.tsv", n=96)
    args = [str(raw), "--encoder", "hash", "--feature_size", "4000",
            "--records_per_shard", "96"]
    assert criteo.main([args[0], str(tmp_path / "data"), *args[1:]]) == 0
    info = json.loads(capsys.readouterr().out)
    assert jax_criteo.main([args[0], str(tmp_path / "jax"), *args[1:]]) == 0
    assert info == json.loads(capsys.readouterr().out)
    assert info == {"shards": 1, "feature_size": 4000, "encoder": "hash"}
    assert (_bytes([tmp_path / "data" / "tr-00000.tfrecords"])
            == _bytes([tmp_path / "jax" / "tr-00000.tfrecords"]))

    from deepfm_tpu_torch.launch.cli import run

    state = run(["--task_type", "train", "--device", "cpu",
                 "--training_data_dir", str(tmp_path / "data"),
                 "--model_dir", str(tmp_path / "model"), "--servable_model_dir", "",
                 "--feature_size", "4000", "--field_size", "39", "--embedding_size", "4",
                 "--deep_layers", "8", "--dropout", "1.0", "--batch_size", "32",
                 "--num_epochs", "1", "--log_steps", "1000",
                 "--checkpoint_every_steps", "0", "--set", "model.compute_dtype=float32"])
    assert state.step == 3
    w = state.model.fm_w.detach().numpy()
    assert np.isfinite(w).all()


@pytest.mark.parametrize("vocab_json", [False, True], ids=["count", "saved-vocab"])
def test_the_vocab_cli_matches_jax(tmp_path, capsys, vocab_json):
    raw = _synthetic_tsv(tmp_path / "raw.tsv", n=150, seed=8)
    outs = []
    for pkg, main in (("port", criteo.main), ("jax", jax_criteo.main)):
        extra = ["--vocab_json", str(tmp_path / f"{pkg}.json")] if vocab_json else []
        for _ in range(2 if vocab_json else 1):  # the second run reuses the saved vocab
            assert main([str(raw), str(tmp_path / pkg), "--encoder", "vocab",
                         "--min_count", "2", "--records_per_shard", "64", *extra]) == 0
        outs.append((json.loads(capsys.readouterr().out.splitlines()[-1]),
                     _bytes(sorted((tmp_path / pkg).iterdir()))))
    assert outs[0] == outs[1]
    assert outs[0][0]["shards"] == 3 and outs[0][0]["encoder"] == "vocab"
