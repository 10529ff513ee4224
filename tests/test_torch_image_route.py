"""Which decoder a JPEG takes, on the CPU, against the JAX package.

- On ``cpu()``, ``imdecode``, ``recordio.unpack_img``, ``ImageIter``,
  ``ImageDetIter``, ``ImageRecordDataset`` and ``ImageFolderDataset``
  decode with libjpeg, bit for bit the JAX package's decode, also where
  a ``DataLoader``'s worker threads read a dataset built inside ``with
  mt.cpu():`` (a thread the block does not reach) and where an iterator
  built there is read outside it: each fixes its context where it is
  built.
- The default context is the card: with no card, building an iterator
  or a dataset, or decoding, raises.  A ``gpu`` context whose nvJPEG
  library cannot be built raises naming nvJPEG, and libjpeg never runs;
  on ``cpu()`` without libjpeg the decode raises naming libjpeg.
- ``ops.image_nvjpeg.decode_jpeg``'s Python side over a stand-in of the
  library: a decoder a thread, the device passed on, refused bytes and
  faults raise their messages.  Its ctypes table is the ``.cu``'s
  ``extern "C"`` entries.
- PNG goes through PIL on any context.
- ``gluon.model_zoo.model_store.get_model_file`` searches in the JAX
  package's order; ``pretrained=True`` loads the file it finds.
- libjpeg's error at full resolution, which ``chip_smoke.py`` holds
  phase 35's ``ImageIter`` batch to (``LIBJPEG_FULL_ERR``).
"""
import ctypes
import gc
import importlib.util
import io
import os
import random
import re
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, _native, profiler, recordio
from mxnet_tpu_torch.gluon.data import DataLoader, vision
from mxnet_tpu_torch.gluon.model_zoo import model_store
from mxnet_tpu_torch.ops import image_nvjpeg as nj

pytest.importorskip("cv2")    # the JAX package's imdecode
N = 6


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _jpeg(i, short=40):
    label, img = mt.test_utils.synthetic_image(1, i, short)
    return label, img, _native.jpeg_encode(img, 90)


@pytest.fixture
def files(tmp_path):
    """N JPEGs in a .rec/.idx, a .lst of files, a class folder and a .rec
    of detection records."""
    rec = recordio.MXIndexedRecordIO(str(tmp_path / "i.idx"),
                                     str(tmp_path / "i.rec"), "w")
    det = recordio.MXIndexedRecordIO(str(tmp_path / "d.idx"),
                                     str(tmp_path / "d.rec"), "w")
    (tmp_path / "cls" / "a").mkdir(parents=True)
    lst = []
    for i in range(N):
        label, _, buf = _jpeg(i)
        rec.write_idx(i, recordio.pack(recordio.IRHeader(0, float(label), i,
                                                         0), buf))
        boxes = np.float32([[i % 3, 0.1, 0.2, 0.5, 0.7]] * (1 + i % 2))
        det.write_idx(i, recordio.pack(recordio.IRHeader(0, boxes.ravel(),
                                                         i, 0), buf))
        (tmp_path / ("%d.jpg" % i)).write_bytes(buf)
        (tmp_path / "cls" / "a" / ("%d.jpg" % i)).write_bytes(buf)
        lst.append("%d\t%f\t%d.jpg" % (i, label, i))
    rec.close()
    det.close()
    (tmp_path / "i.lst").write_text("\n".join(lst) + "\n")
    return tmp_path


# -- cpu(): libjpeg, bit for bit the JAX package -----------------------------
@pytest.mark.parametrize("flag,to_rgb", [(1, True), (0, True), (-1, True),
                                         (1, False)])
def test_imdecode_on_the_cpu_is_the_jax_decode(flag, to_rgb):
    for i in range(N):
        buf = _jpeg(i)[2]
        a = mt.image.imdecode(buf, flag, to_rgb, ctx=mt.cpu())
        b = mx.image.imdecode(buf, flag, to_rgb)
        assert a.context == mt.cpu()
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


@pytest.mark.parametrize("iscolor", [1, 0, -1])
def test_unpack_img_on_the_cpu_is_the_jax_decode(iscolor):
    s = recordio.pack(recordio.IRHeader(0, 2.0, 5, 0), _jpeg(3)[2])
    ha, a = recordio.unpack_img(s, iscolor, ctx=mt.cpu())
    hb, b = mx.recordio.unpack_img(s, iscolor)
    assert tuple(ha) == tuple(hb)
    np.testing.assert_array_equal(a, b)


def _iter_batches(cls, shape, **kw):
    random.seed(4)
    it = cls(2, shape, **kw)
    return [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]


@pytest.mark.parametrize("source", ["rec", "lst"])
def test_image_iter_fixes_its_context_where_it_is_built(files, source):
    """Built inside ``with mt.cpu():`` and read outside it (and in
    another thread): libjpeg, the JAX package's batches."""
    kw = dict(path_imgrec=str(files / "i.rec")) if source == "rec" else \
        dict(path_imglist=str(files / "i.lst"), path_root=str(files))
    aug = dict(resize=30, rand_crop=True, rand_mirror=True, mean=True)
    with mt.cpu():
        random.seed(4)
        it = mt.image.ImageIter(2, (3, 24, 24), **kw, **aug)
    random.seed(4)
    got = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in it]
    want = _iter_batches(mx.image.ImageIter, (3, 24, 24), **kw, **aug)
    assert len(got) == len(want) == N // 2
    for (da, la, pa), (db, lb, pb) in zip(got, want):
        assert pa == pb
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_allclose(da, db, rtol=0, atol=1e-4)


def test_image_det_iter_fixes_its_context_where_it_is_built(files):
    kw = dict(path_imgrec=str(files / "d.rec"))
    with mt.cpu():
        it = mt.image.ImageDetIter(2, (3, 20, 20), **kw)
    random.seed(4)
    got = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in it]
    want = _iter_batches(mx.image.ImageDetIter, (3, 20, 20), **kw)
    assert len(got) == len(want) == N // 2
    for (da, la), (db, lb, _) in zip(got, want):
        np.testing.assert_array_equal(la, lb)
        # the JAX package resizes with cv2's fixed point: within 1 of 255
        np.testing.assert_allclose(da, db, rtol=0, atol=1.0)


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("kind", ["record", "folder"])
def test_datasets_decode_on_their_context_in_workers(files, kind, workers):
    """A dataset built inside ``with mt.cpu():`` decodes with libjpeg in
    a ``DataLoader``'s worker threads, bit for bit the JAX package's."""
    make = {"record": lambda v: v.ImageRecordDataset(str(files / "i.rec")),
            "folder": lambda v: v.ImageFolderDataset(str(files / "cls"))}
    with mt.cpu():
        ds = make[kind](vision)
        loader = DataLoader(ds, batch_size=2, num_workers=workers,
                            batchify_fn=list)
        got = [s for b in loader for s in b]
    ref = make[kind](mx.gluon.data.vision)
    assert len(got) == len(ref) == N
    for i, (img, label) in enumerate(got):
        np.testing.assert_array_equal(img.asnumpy(), ref[i][0].asnumpy())
        assert img.context == mt.cpu() and label == ref[i][1]


# -- the card's route without a card ---------------------------------------
def test_the_default_context_without_a_card_raises(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = _jpeg(0)[2]
    s = recordio.pack(recordio.IRHeader(0, 1.0, 0, 0), buf)
    for call in (lambda: mt.image.imdecode(buf),
                 lambda: recordio.unpack_img(s),
                 lambda: mt.image.ImageIter(2, (3, 8, 8),
                                            path_imgrec=str(files / "i.rec")),
                 lambda: mt.image.ImageDetIter(
                     2, (3, 8, 8), path_imgrec=str(files / "d.rec")),
                 lambda: vision.ImageRecordDataset(str(files / "i.rec")),
                 lambda: vision.ImageFolderDataset(str(files / "cls"))):
        with pytest.raises(MXNetError, match="gpu"):
            call()


class _Gpu:
    """A context that names a card, for the route's choice alone."""
    device_type, device_id = "gpu", 0


def _on_a_card(monkeypatch):
    monkeypatch.setattr(recordio, "as_context", lambda ctx=None: _Gpu())

    def no_libjpeg(*a, **k):
        raise AssertionError("libjpeg ran on a gpu context")
    monkeypatch.setattr(_native, "jpeg_decode", no_libjpeg)


def test_nvjpeg_that_cannot_be_built_raises_naming_it(monkeypatch):
    _on_a_card(monkeypatch)

    def fail():
        raise MXNetError("nvcc not found (set CUDA_HOME)")
    monkeypatch.setattr(nj, "loader_lib", fail)
    buf = _jpeg(0)[2]
    for call in (lambda: recordio.decode_image(buf, 1),
                 lambda: mt.image.imdecode(buf),
                 lambda: recordio.unpack_img(recordio.pack(
                     recordio.IRHeader(0, 1.0, 0, 0), buf))):
        with pytest.raises(MXNetError, match="nvJPEG.*nvcc not found"):
            call()


def test_libjpeg_that_cannot_be_built_raises_naming_it(monkeypatch):
    def fail():
        raise MXNetError("jpeglib.h: No such file")
    monkeypatch.setattr(_native, "image_lib", fail)
    with pytest.raises(MXNetError, match="libjpeg.*jpeglib.h"):
        mt.image.imdecode(b"\xff\xd8\xff\xe0" + b"\x00" * 16, ctx=mt.cpu())


@pytest.mark.parametrize("ctx", ["cpu", "gpu"])
def test_png_goes_through_pil_on_any_context(monkeypatch, ctx):
    pil = pytest.importorskip("PIL.Image")
    img = mt.test_utils.synthetic_image(2, 0, 20)[1]
    bio = io.BytesIO()
    pil.fromarray(img).save(bio, format="PNG")
    if ctx == "gpu":
        _on_a_card(monkeypatch)
        monkeypatch.setattr(nj, "decode_jpeg", None)   # never reached
    got = recordio.decode_image(bio.getvalue(), 1, ctx=mt.cpu())
    np.testing.assert_array_equal(got, img)
    grey = recordio.decode_image(bio.getvalue(), 0, ctx=mt.cpu())
    assert grey.shape == img.shape[:2] + (1,)


# -- decode_jpeg's Python side over a stand-in library ----------------------
class _Lib:
    """The ``mx_nvjpeg_decoder_*`` entries in Python: libjpeg decodes,
    written through the pointers ctypes hands over."""

    def __init__(self):
        self.made, self.freed, self.devices = [], [], []
        self.fault = False

    def mx_nvjpeg_decoder_create(self, device, err, n):
        self.devices.append(device)
        self.made.append(threading.get_ident())
        return len(self.made)

    def mx_nvjpeg_decoder_destroy(self, handle):
        self.freed.append(handle)

    def mx_nvjpeg_image_info(self, handle, buf, n, flag, w, h, c):
        try:
            arr = _native.jpeg_decode(buf, flag)
        except MXNetError:
            return 1
        h._obj.value, w._obj.value, c._obj.value = arr.shape
        return 0

    def mx_nvjpeg_decode_image(self, handle, buf, n, flag, out):
        if self.fault:
            return -1
        arr = np.ascontiguousarray(_native.jpeg_decode(buf, flag))
        ctypes.memmove(out, arr.ctypes.data, arr.nbytes)
        return 0

    def mx_nvjpeg_decoder_error(self, handle):
        return b"cudaMalloc: out of memory"


@pytest.fixture
def stand_in_lib(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(nj, "loader_lib", lambda: lib)
    monkeypatch.setattr(nj, "_local", threading.local())
    yield lib
    gc.collect()


def test_decode_jpeg_gives_the_decoders_pixels(stand_in_lib):
    buf = _jpeg(1)[2]
    for flag in (1, 0, -1):
        got = nj.decode_jpeg(buf, flag, device=0)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, _native.jpeg_decode(buf, flag))
    assert stand_in_lib.devices == [0]       # one decoder for the thread


def test_decode_jpeg_makes_a_decoder_a_thread_and_device(stand_in_lib):
    buf = _jpeg(2)[2]
    before = profiler.counter(nj.DECODERS_COUNTER)

    both = threading.Barrier(2)    # both alive at once: distinct idents

    def work():
        nj.decode_jpeg(buf, 1, device=0)
        nj.decode_jpeg(buf, 1, device=0)
        both.wait()
    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    nj.decode_jpeg(buf, 1, device=1)
    assert stand_in_lib.devices == [0, 0, 1]
    assert len(set(stand_in_lib.made)) == 3     # two threads and this one
    assert profiler.counter(nj.DECODERS_COUNTER) - before == 3
    del threads
    gc.collect()
    assert sorted(stand_in_lib.freed) == [1, 2]    # the workers' decoders


def test_decode_jpeg_refusals_and_faults(stand_in_lib):
    with pytest.raises(MXNetError, match="^Decoding image failed: nvJPEG"):
        nj.decode_jpeg(b"\xff\xd8\xff garbage", 1)
    stand_in_lib.fault = True
    with pytest.raises(MXNetError, match="cuda:0.*out of memory"):
        nj.decode_jpeg(_jpeg(0)[2], 1)


def test_ctypes_table_is_the_sources_extern_c_entries():
    src = open(os.path.join(os.path.dirname(nj.__file__), "csrc",
                            "image_nvjpeg.cu")).read()
    block = src[src.index('extern "C" {'):src.index('}  // extern "C"')]
    names = set(re.findall(r"^[A-Za-z_][\w\s\*]*?\b(mx_\w+)\(", block,
                           re.M))
    assert names == set(nj._SIGNATURES)
    for name in ("mx_nvjpeg_decoder_create", "mx_nvjpeg_image_info",
                 "mx_nvjpeg_decode_image", "mx_nvjpeg_decoder_error",
                 "mx_nvjpeg_decoder_destroy"):
        assert name in names


# -- the model store -----------------------------------------------------------
@pytest.mark.parametrize("where", ["root", "env", "zoo", "nowhere"])
def test_model_store_search_order_matches_jax(tmp_path, monkeypatch, where):
    root, env = tmp_path / "root", tmp_path / "env"
    root.mkdir()
    env.mkdir()
    monkeypatch.setenv("MXNET_GLUON_REPO", str(env))
    zoo_name = "cifar10_synth_mobilenet0.25"
    name = zoo_name if where == "zoo" else "net_a"
    if where in ("root",):
        (root / "net_a.params").write_bytes(b"x")
    if where in ("root", "env"):
        (env / "net_a.params").write_bytes(b"x")
    got = []
    for store in (model_store, mx.gluon.model_zoo.model_store):
        try:
            got.append(os.path.realpath(store.get_model_file(
                name, root=str(root))))
        except FileNotFoundError:
            got.append("FileNotFoundError")
    assert got[0] == got[1]
    want = {"root": str(root / "net_a.params"),
            "env": str(env / "net_a.params"),
            "zoo": os.path.realpath(os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "zoo", zoo_name + ".params")),
            "nowhere": "FileNotFoundError"}[where]
    assert got[0] == os.path.realpath(want) if where != "nowhere" \
        else got[0] == want
    if where == "nowhere":
        with pytest.raises(MXNetError, match="net_a.params"):
            model_store.get_model_file("net_a", root=str(root))


def test_purge_matches_jax(tmp_path):
    for store in (model_store, mx.gluon.model_zoo.model_store):
        (tmp_path / "a.params").write_bytes(b"x")
        (tmp_path / "keep.txt").write_bytes(b"x")
        store.purge(root=str(tmp_path))
        assert sorted(os.listdir(tmp_path)) == ["keep.txt"]
    model_store.purge(root=str(tmp_path / "missing"))


def test_pretrained_loads_the_file_found(tmp_path, monkeypatch):
    """The JAX package's MobileNet 0.25 written as ``mobilenet0.25.params``
    where ``MXNET_GLUON_REPO`` points: ``pretrained=True`` loads it."""
    with mx.cpu():
        ref = mx.gluon.model_zoo.vision.get_model("mobilenet0.25")
        mx.random.seed(5)
        ref.initialize(mx.init.Xavier())
        ref(mx.nd.zeros((1, 3, 32, 32)))
        ref.save_params(str(tmp_path / "mobilenet0.25.params"))
    monkeypatch.setenv("MXNET_GLUON_REPO", str(tmp_path))
    with mt.cpu():
        net = mt.gluon.model_zoo.vision.get_model("mobilenet0.25",
                                                  pretrained=True)
    a = {k[len(net.prefix):]: v.data().asnumpy()
         for k, v in net.collect_params().items()}
    b = {k[len(ref.prefix):]: v.data().asnumpy()
         for k, v in ref.collect_params().items()}
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])


# -- the bound phase 35 holds the card's ImageIter to -------------------------
def test_libjpeg_error_at_full_resolution():
    """libjpeg's decode of phase 26's first 32 images (PIL-encoded at
    quality 95, as on the card's host) against the images before
    encoding, at full resolution (x 255 scale): ``LIBJPEG_FULL_ERR``."""
    smoke = _chip_smoke()
    err = []
    for i in range(32):
        _, img = mt.test_utils.synthetic_image(0, i, smoke.DATA_SHORT)
        buf = mt.test_utils.pil_jpeg(img, smoke.DATA_QUALITY)
        err.append(np.abs(_native.jpeg_decode(buf, 1).astype(np.float64)
                          - img).ravel())
    err = np.concatenate(err)
    got = {"mean": err.mean(), "rms": np.sqrt((err ** 2).mean())}
    print("libjpeg decode vs the images (full resolution): mean %.4f, "
          "rms %.4f" % (got["mean"], got["rms"]))
    for k, v in smoke.LIBJPEG_FULL_ERR.items():
        assert abs(got[k] - v) < 1e-4
        assert v > smoke.LIBJPEG_ERR[k]


def test_module_output_shapes_infer_in_the_bound_dtype():
    """``Module.output_shapes`` of a graph whose parameters are fp64 (a
    convolution with a bias) infers at the bound dtypes: the shapes of
    the JAX package's forward.  (The JAX package's own ``output_shapes``
    infers in float32 and raises here.)"""
    got = []
    for pkg in (mt, mx):
        with pkg.cpu(), pkg.name.NameManager():
            conv = pkg.gluon.nn.Conv2D(2, 3, in_channels=1)
            conv.cast("float64")
            mod = pkg.mod.Module(conv(pkg.sym.Variable("data")),
                                 label_names=(), context=pkg.cpu())
            mod.bind([pkg.io.DataDesc("data", (2, 1, 5, 5),
                                      dtype="float64")])
            mod.init_params(initializer=pkg.init.Xavier())
            mod.forward(pkg.io.DataBatch([pkg.nd.ones((2, 1, 5, 5),
                                                      dtype="float64")]),
                        is_train=False)
            got.append([(n, tuple(o.shape)) for n, o in zip(
                mod.output_names, mod.get_outputs())])
            if pkg is mt:
                assert [(n, tuple(s)) for n, s in mod.output_shapes] \
                    == got[0]
    assert got[0] == got[1] and got[0][0][1] == (2, 2, 3, 3)
