"""The port's host data modules against the JAX package's on the same
inputs, with the JAX modules as the oracle (the JAX side's own tests are
tests/test_tokenizer.py, test_encoding.py, test_dataset.py, test_loader.py
and test_lmdb.py): tokenizer ids equal; encoded sequences and images equal
byte for byte; every split's items equal (seeded train items over two
epochs, val, test), ``collate`` and ``flatten_for_forward`` with the
``sample_size`` / ``rng`` training subsample; loader batches equal
(shuffled, sharded over processes, with and without ``drop_last``); the
LMDB writer's files and both readers' bytes equal (the native reader skips
without g++, as tests/test_lmdb.py:62 does); the feature readers and
converters equal; and ``tools/fixture_tree.py``'s files equal byte for
byte to ``tests/fixtures.py``'s at the same seed. Every comparison is
exact (no tolerance).
"""

import os
import pickle

import numpy as np
import pytest

from tests import fixtures
from tests.test_lmdb import make_items
from tests.test_tokenizer import VOCAB
from unimm_torch.data import dataset as TD
from unimm_torch.data import encoding as TE
from unimm_torch.data import features as TF
from unimm_torch.data.loader import DataLoader as TLoader
from unimm_torch.data.loader import batch_iter as t_batch_iter
from unimm_torch.data.tokenizer import WordPieceTokenizer as TTok
from unimm_torch.native import lmdb as t_lmdb
from unimm_torch.native import lmdb_format as t_fmt
from unimm_torch.tools import fixture_tree
from unimm_tpu.data import dataset as JD
from unimm_tpu.data import encoding as JE
from unimm_tpu.data import features as JF
from unimm_tpu.data.loader import DataLoader as JLoader
from unimm_tpu.data.loader import batch_iter as j_batch_iter
from unimm_tpu.data.tokenizer import WordPieceTokenizer as JTok
from unimm_tpu.native import lmdb as j_lmdb
from unimm_tpu.native import lmdb_format as j_fmt


def assert_items_equal(got, want):
    """Two dicts of arrays (or scalars / None) equal key for key, dtype and
    bytes."""
    assert got.keys() == want.keys()
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


# --- tokenizer ---------------------------------------------------------------

FUZZ = ["the cat sat on the mat", "unaffable running runs", "Héllo, WORLD!",
        "cat's 2020 a.b.c", "中文 mixed 가나 text",
        "zero​width nbsp\ttab\ncontrol\x07", "emoji \U0001f600 ok",
        "a" * 120 + " the", "", "   ", "Ünïcödé àccents ÇÃ"]


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    p.write_text("\n".join(VOCAB) + "\n")
    return str(p)


def test_tokenizer_ids_equal(vocab_file):
    t, j = TTok.from_vocab_file(vocab_file), JTok.from_vocab_file(vocab_file)
    rng = np.random.default_rng(0)
    pieces = VOCAB[5:] + ["é", "中", "!!", "##", "x", " "]
    texts = FUZZ + ["".join(rng.choice(pieces, int(rng.integers(1, 12))))
                    for _ in range(300)]
    for s in texts:
        assert t.tokenize(s) == j.tokenize(s), s
        assert t.encode(s) == j.encode(s), s
    assert (t.cls_id, t.sep_id, t.mask_id, t.vocab_size) == \
        (j.cls_id, j.sep_id, j.mask_id, j.vocab_size)
    assert t.decode(t.encode(FUZZ[0])) == j.decode(j.encode(FUZZ[0]))


# --- encoding ----------------------------------------------------------------

def _utterances(rng, n, max_words):
    return [rng.integers(5, 60, int(rng.integers(1, max_words))).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("fn", ["encode_gen", "encode_dis", "encode_auto"])
@pytest.mark.parametrize("max_len,neg", [(256, False), (40, True),
                                         (24, False)])
def test_encoded_sequences_equal(fn, max_len, neg):
    rng = np.random.default_rng(max_len + neg)
    seqs = {"t": [], "j": []}
    for case in range(12):
        utt = _utterances(rng, int(rng.integers(1, 12)), 9)
        kw = dict(max_seq_len=max_len, mask_prob=0.15, is_negative=neg,
                  weight=2.5 if neg else 1.0, vocab_size=60)
        for side, E in (("t", TE), ("j", JE)):
            args = ((0.5,) if fn == "encode_auto" else ()) + (
                utt, case % 2, 2, 3, 4)
            seqs[side].append(getattr(E, fn)(
                *args, rng=np.random.default_rng(case), **kw))
    for g, w in zip(seqs["t"], seqs["j"]):
        assert_items_equal(vars(g), vars(w))
    assert_items_equal(TE.stack_sequences(seqs["t"]),
                       JE.stack_sequences(seqs["j"]))


def test_encoded_images_and_pruning_equal():
    rng = np.random.default_rng(3)
    for n, max_regions in ((5, 12), (30, 12), (12, 12)):
        feats = rng.normal(size=(n, 16)).astype(np.float32)
        boxes = np.abs(rng.normal(size=(n, 5))).astype(np.float32)
        cls_prob = rng.dirichlet(np.ones(8), n).astype(np.float32)
        got, want = (E.encode_image(feats, n, boxes, cls_prob,
                                    max_regions=max_regions, mask_prob=0.3,
                                    rng=np.random.default_rng(n))
                     for E in (TE, JE))
        assert_items_equal(vars(got), vars(want))
    ctx = _utterances(rng, 23, 5)
    for rounds in (1, 4, 11):
        assert TE.prune_rounds(list(ctx), rounds) == \
            JE.prune_rounds(list(ctx), rounds)


# --- datasets ----------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("visdial")
    paths, _, _ = fixtures.write_fixture_tree(str(root))
    params = fixtures.default_params(paths)
    return params, paths


def _datasets(params, paths, **over):
    p = dict(params, **over)
    t = TD.VisdialDataset(p, TTok.from_vocab_file(paths["vocab_path"]),
                          TF.open_features(paths["visdial_image_feats"]))
    j = JD.VisdialDataset(p, JTok.from_vocab_file(paths["vocab_path"]),
                          JF.open_features(paths["visdial_image_feats"]))
    return t, j


@pytest.mark.parametrize("split,over", [
    ("train", {}), ("train", {"train_dis_rate": 0.0,
                              "num_negative_samples": 3}),
    ("val", {}), ("val", {"val_dis": 0, "num_options": 100}),
    ("test", {}), ("test", {"test_dis": 0}),
    ("val", {"overfit": True}), ("train", {"num_train_samples": 4}),
])
def test_split_items_equal(world, split, over):
    t, j = _datasets(*world, **over)
    t.split = j.split = split
    assert len(t) == len(j) > 0
    for epoch in ((0, 1) if split == "train" else (0,)):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        for i in range(len(j)):
            assert_items_equal(t[i], j[i])
    assert t.stats == j.stats


def test_collate_and_flatten_subsample_equal(world):
    t, j = _datasets(*world)
    t.split = j.split = "train"
    tb = TD.collate([t[i] for i in range(3)])
    jb = JD.collate([j[i] for i in range(3)])
    assert_items_equal(tb, jb)
    for kw in ({}, {"train": False}, {"compact_images": True},
               {"train": False, "compact_images": True}):
        assert_items_equal(TD.flatten_for_forward(tb, **kw),
                           JD.flatten_for_forward(jb, **kw))
        for size in (7, 40):
            got = TD.flatten_for_forward(
                tb, size, np.random.default_rng(size), **kw)
            want = JD.flatten_for_forward(
                jb, size, np.random.default_rng(size), **kw)
            assert_items_equal(got, want)
            assert got["tokens"].shape[0] == size


# --- loader ------------------------------------------------------------------

class _Items:
    def __init__(self, n):
        self.n, self.epoch = n, 0

    def set_epoch(self, e):
        self.epoch = e

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.asarray([i, self.epoch]),
                "y": np.full((2, 3), i, np.float32)}


@pytest.mark.parametrize("kw", [
    dict(batch_size=5), dict(batch_size=5, shuffle=True, seed=3),
    dict(batch_size=4, drop_last=True, shuffle=True),
    dict(batch_size=5, process_index=1, process_count=2),
    dict(batch_size=7, process_index=0, process_count=3, shuffle=True),
])
def test_loader_batches_equal(kw):
    bs = kw.pop("batch_size")
    t = TLoader(_Items(23), bs, num_workers=2, **kw)
    j = JLoader(_Items(23), bs, num_workers=2, **kw)
    assert len(t) == len(j)
    got = list(t_batch_iter(t, 2))
    want = list(j_batch_iter(j, 2))
    assert [(e, i) for e, i, _ in got] == [(e, i) for e, i, _ in want]
    for (_, _, g), (_, _, w) in zip(got, want):
        assert_items_equal(g, w)


def test_loader_on_the_dataset_equal(world):
    t, j = _datasets(*world)
    t.split = j.split = "val"
    for g, w in zip(TLoader(t, 2, num_workers=2), JLoader(j, 2,
                                                         num_workers=2)):
        assert_items_equal(g, w)


def test_training_loader_rejects_nondivisible_shards():
    with pytest.raises(ValueError, match="must divide"):
        TLoader(_Items(10), 5, drop_last=True, process_count=2)


# --- LMDB --------------------------------------------------------------------

@pytest.fixture(scope="module")
def db(tmp_path_factory):
    items = make_items(np.random.default_rng(0))
    d = tmp_path_factory.mktemp("db")
    t_path, j_path = str(d / "t.lmdb"), str(d / "j.lmdb")
    t_fmt.Writer().write(t_path, items)
    j_fmt.Writer().write(j_path, items)
    return t_path, j_path, dict(items)


def _read_all(reader):
    return dict(reader.items()), reader.entries


def test_lmdb_writer_files_equal(db):
    t_path, j_path, _ = db
    for f in os.listdir(j_path):
        with open(os.path.join(t_path, f), "rb") as a, \
                open(os.path.join(j_path, f), "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("backend", ["python", "native"])
def test_lmdb_readers_equal(db, backend):
    t_path, j_path, expected = db
    cls_t = t_lmdb._PythonDB if backend == "python" else t_lmdb._NativeDB
    cls_j = j_lmdb._PythonDB if backend == "python" else j_lmdb._NativeDB
    try:
        got, want = cls_t(t_path), cls_j(j_path)
    except RuntimeError:
        pytest.skip("no C++ toolchain")
    assert got.backend == backend
    assert _read_all(got) == _read_all(want) == (expected, len(expected))
    for key in list(expected)[:60] + [b"missing", b""]:
        assert got.get(key) == want.get(key)
    got.close()
    want.close()


def test_native_reader_builds_outside_its_source(db):
    try:
        t_lmdb._NativeDB(db[0]).close()
    except RuntimeError:
        pytest.skip("no C++ toolchain")
    so = t_lmdb._build_native()
    assert os.path.basename(os.path.dirname(so)) == "unimm_torch"
    assert os.path.basename(os.path.dirname(os.path.dirname(so))) == "build"
    assert not os.path.exists(os.path.join(os.path.dirname(t_lmdb.__file__),
                                           "_lmdb_reader.so"))


def test_feature_readers_and_converters_equal(world, tmp_path):
    _, paths = world
    npz = paths["visdial_image_feats"]
    t_db, j_db = str(tmp_path / "t.lmdb"), str(tmp_path / "j.lmdb")
    TF.convert_npz_to_lmdb(npz, t_db)
    JF.convert_npz_to_lmdb(npz, j_db)
    for f in os.listdir(j_db):
        assert (open(os.path.join(t_db, f), "rb").read()
                == open(os.path.join(j_db, f), "rb").read()), f
    t_npz, j_npz = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    TF.convert_lmdb_to_npz(t_db, t_npz)
    JF.convert_lmdb_to_npz(j_db, j_npz)
    readers = [(TF.open_features(t_db), JF.open_features(j_db)),
               (TF.open_features(t_npz), JF.open_features(j_npz)),
               (TF.open_features(npz), JF.open_features(npz))]
    raw = pickle.loads(JF.LmdbFeatureReader(j_db).db.get(b"1000"))
    readers.append((TF.DictFeatureReader({1000: raw}),
                    JF.DictFeatureReader({1000: raw})))
    for t, j in readers:
        keys = j.keys()
        assert t.keys() == keys
        for k in list(keys)[:4]:
            k = int(k.decode()) if isinstance(k, bytes) else k
            for g, w in zip(t[k], j[k]):
                assert_items_equal({"v": g}, {"v": w})


# --- the fixture writer ------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(n_val=4, feat_dim=16, n_classes=8,
                                         seed=3)])
def test_fixture_tree_files_equal(tmp_path, kw):
    t_paths, t_tok, t_reader = fixture_tree.write_fixture_tree(
        str(tmp_path / "t"), **kw)
    j_paths, j_tok, j_reader = fixtures.write_fixture_tree(
        str(tmp_path / "j"), **kw)
    assert t_paths.keys() == j_paths.keys()
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    for name in names:
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name
    assert t_tok.vocab == j_tok.vocab
    for k in j_reader.keys():
        for g, w in zip(t_reader[k], j_reader[k]):
            assert_items_equal({"v": g}, {"v": w})
