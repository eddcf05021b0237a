"""The port's Bury-2021 classifiers (``eval/bury.py``) and its HDF5 reader
(``utils/h5lite.py``) against the JAX package's Keras path (CPU).

``h5lite`` reads every dataset of the 20 tracked archives bit for bit as h5py
does, and refuses what it does not read. Each torch classifier is held to the
Keras model that the JAX package's ``load_classifiers`` returns, within 1e-5
in probability, on the stacked prefixes of the demo record and on seeded
noise (one Keras call per classifier). The prefix protocol is held bit for
bit to the JAX package's ``_classify_prefix``; ``apply_bury_classifiers`` and
``run_one`` end to end at two classifiers and three prefixes (Keras takes
about a second a call here). The weight binding is held to the JAX
package's on tracked and edited archives, refusals included.
"""
import csv
import io
import json
import zipfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from upgdm_tpu.eval import bury as JB
from upgdm_tpu_torch.eval import bury as PB
from upgdm_tpu_torch.utils import io as pio
from upgdm_tpu_torch.utils import h5lite
from upgdm_tpu_torch.utils.h5lite import read_h5
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
LEN500 = PB.DEFAULT_MODEL_ROOT / "len500"
ARCHIVES = sorted(LEN500.glob("best_model_*_len500.keras"))
DEMO_RECORD = REPO / "demo_real/data/slbp_empirical_demo.pt"
PROB_ATOL = 1e-5  # torch against Keras, float32 on the CPU


def _member(path, name):
    with zipfile.ZipFile(path) as z:
        return z.read(name)


def _prefixes():
    """The demo record's pre-transition prefixes (as ``run_one`` takes them)
    and seeded noise, stacked: [n, 500, 1] float32."""
    record = pio.load_pt(DEMO_RECORD)
    res, _y, times, tt = PB.prepare_series(record, 0, "lowess", 0.2, 0.2)
    res = res[times <= tt][-500:]
    noise = np.random.default_rng(0).normal(size=(6, 500, 1)).astype(np.float32)
    return np.concatenate([PB.prefix_windows(res, 10, 500), noise])


def _tensorflow():
    """TensorFlow on one thread where it is not running yet: its pools took
    every CPU of each test worker, and its calls ran ~1.7x slower."""
    tf = pytest.importorskip("tensorflow")
    try:
        tf.config.threading.set_intra_op_parallelism_threads(1)
        tf.config.threading.set_inter_op_parallelism_threads(1)
    except RuntimeError:
        pass  # initialised by an earlier test of this worker
    return tf


@pytest.fixture(scope="module")
def keras_classifiers():
    _tensorflow()
    return JB.load_classifiers(JB.DEFAULT_MODEL_ROOT, 500)


# -- h5lite ----------------------------------------------------------------------

def test_h5lite_reads_every_tracked_dataset_as_h5py():
    h5py = pytest.importorskip("h5py")
    assert len(ARCHIVES) == 20
    n = 0
    for path in ARCHIVES:
        data = _member(path, "model.weights.h5")
        tree = read_h5(data)
        with h5py.File(io.BytesIO(data), "r") as f:
            def walk(node, group):
                nonlocal n
                assert sorted(node) == sorted(group.keys())
                for k, v in group.items():
                    if isinstance(v, h5py.Dataset):
                        want = v[()]
                        got = node[k]
                        assert got.dtype == want.dtype and got.shape == want.shape
                        assert got.tobytes() == np.asarray(want).tobytes()
                        n += 1
                    else:
                        walk(node[k], v)
            walk(tree, f)
    assert n == 320


def _h5(fill, **kw):
    h5py = pytest.importorskip("h5py")
    buf = io.BytesIO()
    with h5py.File(buf, "w", **kw) as f:
        f.create_dataset("plain", data=np.arange(6, dtype="<f4").reshape(2, 3))
        f.attrs["note"] = 1
        fill(f)
    return buf.getvalue()


@pytest.mark.parametrize("case, fill, kw, match", [
    ("chunked", lambda f: f.create_dataset("x", data=np.ones((4, 4), "f4"), chunks=(2, 2)),
     {}, "chunked"),
    ("gzip", lambda f: f.create_dataset("x", data=np.ones((4, 4), "f4"), compression="gzip"),
     {}, "filter"),
    ("int", lambda f: f.create_dataset("x", data=np.ones(4, "i4")), {}, "datatype class"),
    ("big-endian", lambda f: f.create_dataset("x", data=np.ones(4, ">f8")), {}, "big-endian"),
    ("half", lambda f: f.create_dataset("x", data=np.ones(4, "f2")), {}, "2 bytes"),
    ("new-style", lambda f: None, {"libver": "latest"}, "superblock version"),
])
def test_h5lite_refuses_what_it_does_not_read(case, fill, kw, match):
    with pytest.raises(NotImplementedError, match=match):
        read_h5(_h5(fill, **kw))


def test_h5lite_reads_scalars_float64_and_nested_groups():
    def fill(f):
        f.create_group("a/b").create_dataset("x", data=np.linspace(0, 1, 7))
        f.create_dataset("s", data=np.float32(3.5))
    tree = read_h5(_h5(fill))
    assert tree["s"].shape == () and tree["s"].dtype == np.float32 and tree["s"] == 3.5
    np.testing.assert_array_equal(tree["a"]["b"]["x"], np.linspace(0, 1, 7))
    np.testing.assert_array_equal(tree["plain"], np.arange(6, dtype="<f4").reshape(2, 3))
    with pytest.raises(ValueError, match="not an HDF5 file"):
        read_h5(b"\0" * 600)


def test_h5lite_follows_continuations_and_deep_group_trees():
    """300 links in one group (a B-tree of two levels over many SNOD nodes)
    and 40 attributes on a dataset (its header continued elsewhere)."""
    def fill(f):
        g = f.create_group("many")
        for i in range(300):
            g.create_dataset(f"d{i}", data=np.full(3, i, "f8"))
        d = f.create_dataset("attrs", data=np.arange(5, dtype="f4"))
        for i in range(40):
            d.attrs[f"a{i}"] = np.arange(20)
    data = _h5(fill)
    seen = {"levels": set(), "continuations": 0}
    leaves, messages = h5lite._Reader._btree_leaves, h5lite._Reader._messages

    def spy_leaves(self, node):
        seen["levels"].add(self.b[node + 5])
        return leaves(self, node)

    def spy_messages(self, addr):
        out = messages(self, addr)
        seen["continuations"] += sum(m[0] == 0x10 for m in out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(h5lite._Reader, "_btree_leaves", spy_leaves)
        mp.setattr(h5lite._Reader, "_messages", spy_messages)
        tree = read_h5(data)
    assert seen["levels"] == {0, 1} and seen["continuations"] > 0
    assert sorted(tree["many"]) == sorted(f"d{i}" for i in range(300))
    for i in (0, 7, 299):
        np.testing.assert_array_equal(tree["many"][f"d{i}"], np.full(3, i, "f8"))
    np.testing.assert_array_equal(tree["attrs"], np.arange(5, dtype="f4"))


# -- the classifier ----------------------------------------------------------------

def test_every_classifier_matches_keras(keras_classifiers):
    x = _prefixes()
    ported = PB.load_classifiers(PB.DEFAULT_MODEL_ROOT, 500, device="cpu")
    assert [n for n, _ in ported] == [n for n, _ in keras_classifiers]
    assert [n for n, _ in ported][:3] == ["best_model_10_1_len500", "best_model_10_2_len500",
                                          "best_model_1_1_len500"]
    worst = 0.0
    with torch.no_grad():
        for (name, clf), (_n, keras) in zip(ported, keras_classifiers):
            got = clf(torch.from_numpy(x)).numpy()
            want = np.asarray(keras(x))
            assert got.shape == want.shape == (len(x), 4), name
            worst = max(worst, float(np.abs(got - want).max()))
            np.testing.assert_allclose(got.sum(1), 1.0, atol=PROB_ATOL)
    assert worst <= PROB_ATOL, worst
    print(f"largest |p_torch - p_keras| over 20 classifiers x {len(x)} inputs: {worst:.3g}")


def test_classifier_layout_is_the_archives():
    clf = PB.load_keras_model(ARCHIVES[0], device="cpu")
    assert clf.input_shape == (500, 1)
    assert [type(l).__name__ for l in clf.body] == [
        "_Conv1D", "Identity", "_MaxPooling1D", "_LSTM", "Identity", "_LSTM", "Identity", "_Dense"]
    conv, lstm1, lstm2 = clf.body[0], clf.body[3], clf.body[5]
    assert conv.pad == (5, 6)  # Keras's "same" for an even kernel of 12
    assert (lstm1.units, lstm2.units) == (50, 10)
    assert lstm1.return_sequences and not lstm2.return_sequences
    assert torch.count_nonzero(lstm1.lstm.bias_hh_l0) == 0


def _edit(config, layer, **change):
    cfg = json.loads(json.dumps(config))
    for lc in cfg["config"]["layers"]:
        if lc["class_name"] == layer:
            lc["config"].update(change)
            return cfg
    raise KeyError(layer)


@pytest.mark.parametrize("layer, change, match", [
    ("LSTM", {"recurrent_activation": "hard_sigmoid"}, "recurrent_activation"),
    ("LSTM", {"go_backwards": True}, "go_backwards"),
    ("LSTM", {"activation": "relu"}, "activation"),
    ("Conv1D", {"padding": "causal"}, "padding"),
    ("Conv1D", {"strides": [2]}, "strides"),
    ("MaxPooling1D", {"padding": "same"}, "padding"),
    ("Dense", {"activation": "selu"}, "selu"),
])
def test_unsupported_options_raise(layer, change, match):
    config = json.loads(_member(ARCHIVES[0], "config.json"))
    PB.BuryClassifier(config)
    with pytest.raises(NotImplementedError, match=match):
        PB.BuryClassifier(_edit(config, layer, **change))


def test_unsupported_layer_class_raises():
    config = json.loads(_member(ARCHIVES[0], "config.json"))
    config["config"]["layers"].insert(-1, {"class_name": "Flatten", "config": {"name": "f"}})
    with pytest.raises(NotImplementedError, match="Flatten"):
        PB.BuryClassifier(config)


# -- the weight binding against the JAX package's -----------------------------------

class _FakeLayer:
    def __init__(self, name, shapes):
        self.name, self.shapes, self.bound = name, shapes, None
        self.weights = [None] * len(shapes)

    def get_weights(self):
        return [np.zeros(s, np.float32) for s in self.shapes]

    def set_weights(self, arrays):
        self.bound = arrays


def _archive(tmp_path, source, rename=None, drop=()):
    """A copy of ``source`` whose weight groups are renamed or dropped
    (h5py writes the new file)."""
    h5py = pytest.importorskip("h5py")
    tree = read_h5(_member(source, "model.weights.h5"))
    buf = io.BytesIO()
    with h5py.File(buf, "w") as f:
        for name, group in tree["layers"].items():
            if name in drop:
                continue
            out = f.create_group(f"layers/{(rename or {}).get(name, name)}")
            bank = group["cell"]["vars"] if "cell" in group else group["vars"]
            vars_ = out.create_group("cell/vars" if "cell" in group else "vars")
            for i, a in bank.items():
                vars_.create_dataset(i, data=a)
    path = tmp_path / source.name
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("config.json", _member(source, "config.json"))
        z.writestr("model.weights.h5", buf.getvalue())
    return path


def _bind_both(path):
    """(JAX's binding on fake Keras layers, the port's) of one archive:
    {layer name: arrays} each, or the exception raised."""
    clf = PB.BuryClassifier(json.loads(_member(path, "config.json")))
    layers = [_FakeLayer(n, l.keras_shapes()) for n, l in clf.weighted_layers()]
    out = []
    try:
        JB._bind_archive_weights(SimpleNamespace(layers=layers), path)
        out.append({l.name: l.bound for l in layers})
    except ValueError as e:
        out.append(e)
    try:
        ported = PB.load_keras_model(path, device="cpu")
        out.append(ported)
    except ValueError as e:
        out.append(e)
    return out


@pytest.mark.parametrize("source, rename, drop, error", [
    ("best_model_10_1_len500", None, (), None),          # names match (phase 1)
    ("best_model_2_1_len500", None, (), None),           # lstm_2/lstm_3 -> lstm/lstm_1
    ("best_model_1_1_len500", {"lstm": "lstm_10", "lstm_1": "lstm_2"}, (), None),
    ("best_model_1_1_len500", {"dense": "lstm_9"}, (), "base names differ"),
    ("best_model_1_1_len500", None, ("lstm_1",), "Cannot bind"),
])
def test_binding_matches_jax(tmp_path, source, rename, drop, error):
    path = _archive(tmp_path, LEN500 / f"{source}.keras", rename, drop)
    want, got = _bind_both(path)
    if error is not None:
        assert isinstance(want, ValueError) and error in str(want)
        assert isinstance(got, ValueError) and error in str(got)
        return
    for name, layer in got.weighted_layers():
        keras_shaped = want[name]
        state = [p.detach().numpy() for p in layer.parameters()]
        if isinstance(layer, PB._LSTM):
            expect = [keras_shaped[0].T, keras_shaped[1].T, keras_shaped[2],
                      np.zeros_like(keras_shaped[2])]
        elif isinstance(layer, PB._Conv1D):
            expect = [np.transpose(keras_shaped[0], (2, 1, 0)), keras_shaped[1]]
        else:
            expect = [keras_shaped[0].T, keras_shaped[1]]
        assert len(state) == len(expect)
        for a, b in zip(state, expect):
            np.testing.assert_array_equal(a, b)


# -- the prefix protocol and the pipeline ---------------------------------------------

class _Recorder:
    def __init__(self):
        self.seen = []

    def __call__(self, x):
        self.seen.append(np.array(x))
        return np.full((1, 4), 0.25, np.float32)


def test_prefix_windows_are_jax_bit_for_bit():
    rng = np.random.default_rng(3)
    for n, inc, L in ((37, 10, 500), (1200, 100, 500), (60, 7, 20), (5, 5, 8)):
        res = rng.normal(size=n) * rng.uniform(0.1, 10)
        if n == 5:
            res[:] = 0.0  # mean |r| = 0: no division
        rec = _Recorder()
        for end in range(inc, n + 1, inc):
            JB._classify_prefix([("r", rec)], res[:end], L)
        got = PB.prefix_windows(res, inc, L)
        assert got.dtype == np.float32 and got.shape == (len(rec.seen), L, 1)
        for g, w in zip(got, rec.seen):
            assert g.tobytes() == w[0].tobytes()


def test_apply_matches_jax_end_to_end(keras_classifiers):
    pd = pytest.importorskip("pandas")
    record = pio.load_pt(DEMO_RECORD)
    res, _y, times, _tt = PB.prepare_series(record, 0, "lowess", 0.2, 0.2)
    jres = JB.prepare_series(record, 0, "lowess", 0.2, 0.2)
    np.testing.assert_array_equal(res, jres[0].to_numpy())
    np.testing.assert_array_equal(times, jres[0].index.to_numpy())
    assert PB.transition_time(record) == JB.transition_time(record)
    ported = PB.load_classifiers(PB.DEFAULT_MODEL_ROOT, 500, max_models=2, device="cpu")
    state = pd.Series(res[:30], index=times[:30])
    want = JB.apply_bury_classifiers(state, keras_classifiers[:2], 10, 500)
    got = PB.apply_bury_classifiers(res[:30], times[:30], ported, 10, 500)
    assert list(got) == list(want.columns) == PB.TABLE_COLUMNS
    np.testing.assert_array_equal(got["time"], want["time"].to_numpy())
    for c in PB.TABLE_COLUMNS[1:]:
        assert got[c].dtype == want[c].dtype == np.float32
        np.testing.assert_allclose(got[c], want[c].to_numpy(), rtol=0, atol=PROB_ATOL)
    with pytest.raises(ValueError, match="two time points"):
        PB.apply_bury_classifiers(res[:1], times[:1], ported, 10, 500)
    with pytest.raises(RuntimeError, match="did not produce"):
        PB.apply_bury_classifiers(res[:5], times[:5], ported, 10, 500)


def _args(tmp_path, name, **kw):
    return SimpleNamespace(
        data_root=tmp_path / "data", model_root=PB.DEFAULT_MODEL_ROOT,
        output_root=tmp_path / name, pred_dim=0, classifier_len=None, max_models=2,
        inc_points=10, detrend_method="lowess", detrend_span=0.2, detrend_bandwidth=0.2,
        full_prefix=False, **kw)


def test_run_one_writes_jax_outputs(tmp_path):
    """Both packages' ``run_one`` on a 30-point cut of the demo record (three
    prefixes, two classifiers): the CSV as numbers, the ``.pt`` keys and
    dtypes, the metadata JSON."""
    _tensorflow()
    record = pio.load_pt(DEMO_RECORD)
    cut = dict(record, name="demo_cut", ys_dynamic=record["ys_dynamic"][:30],
               ts_dynamic=record["ts_dynamic"][:30])
    pio.save_pt(cut, tmp_path / "data" / "demo_cut.pt")
    want = JB.run_one(_args(tmp_path, "jax"), "demo_cut")
    got = PB.run_one(_args(tmp_path, "port", device="cpu"), "demo_cut")
    assert [p.name for p in got] == [p.name for p in want]
    with open(got[0]) as f, open(want[0]) as g:
        a, b = list(csv.reader(f)), list(csv.reader(g))
    assert a[0] == b[0] and len(a) == len(b) == 4
    np.testing.assert_allclose(np.asarray(a[1:], float), np.asarray(b[1:], float),
                               rtol=0, atol=PROB_ATOL)
    pa, pb = pio.load_pt(got[1]), pio.load_pt(want[1])
    assert sorted(pa) == sorted(pb)
    for k in pb:
        if isinstance(pb[k], np.ndarray):
            assert pa[k].dtype == pb[k].dtype and pa[k].shape == pb[k].shape, k
            np.testing.assert_allclose(pa[k], pb[k], rtol=0, atol=PROB_ATOL)
        else:
            assert pa[k] == pb[k], k
    assert got[2].read_text() == want[2].read_text()


def test_loader_glob_order_filter_and_missing_lengths(tmp_path):
    names = [n for n, _ in PB.load_classifiers(PB.DEFAULT_MODEL_ROOT, 500, device="cpu")]
    assert names == sorted(p.stem for p in ARCHIVES)
    assert [n for n, _ in PB.load_classifiers(PB.DEFAULT_MODEL_ROOT, 500, max_models=3,
                                              device="cpu")] == names[:3]
    for mod in (PB, JB):
        with pytest.raises(FileNotFoundError, match="len1500"):
            mod.load_classifiers(PB.DEFAULT_MODEL_ROOT, 1500)
    (tmp_path / "len500").mkdir()
    (tmp_path / "len500" / "best_model_1_1_len500.keras").write_bytes(b"x" * 1000)
    for mod in (PB, JB):
        with pytest.raises(FileNotFoundError, match="No complete Keras models"):
            mod.load_classifiers(tmp_path, 500)


@pytest.mark.parametrize("record, name", [
    ({"name": "bury_2021_thermoacoustic_tsid_1"}, "x"),
    ({"data_type": "anoxia"}, "x"),
    ({"record": "paleoclimate"}, "tsid_3"),
    ({"record": "paleoclimate"}, "tsid_4"),
    ({"num_time_points": 2000}, "x"),
    ({"num_time_points": 20}, "x"),
])
def test_infer_classifier_length_is_jax(record, name):
    assert PB.infer_classifier_length(record, name) == JB.infer_classifier_length(record, name)


def test_cli_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    record = pio.load_pt(DEMO_RECORD)
    pio.save_pt(record, tmp_path / "data" / "slbp_empirical_demo.pt")
    argv = ["--data-root", str(tmp_path / "data"), "--output-root", str(tmp_path / "out"),
            "--data-real-names", "slbp_empirical_demo", "--max-models", "1"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PB.main(argv)
    assert not (tmp_path / "out").exists()
    PB.main(argv + ["--device", "cpu"])
    rows = list(csv.reader(open(tmp_path / "out/slbp_empirical_demo/"
                                "slbp_empirical_demo_bury_ml_probs.csv")))
    probs = np.asarray(rows[1:], float)
    assert rows[0] == PB.TABLE_COLUMNS and len(probs) == 44
    np.testing.assert_allclose(probs[:, 1:5].sum(1), 1.0, atol=PROB_ATOL)
    np.testing.assert_allclose(probs[:, 5], probs[:, 1:4].sum(1), atol=1e-6)
