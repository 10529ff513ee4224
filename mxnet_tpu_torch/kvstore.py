"""KVStore: the gradient sum over several contexts, and the update on the
store.

Counterpart of ``mxnet_tpu/kvstore.py:1-524`` and ``create`` (:885).  A
store holds one copy of each key.  ``push`` sums a list of per-context
copies on the first copy's device (``_ctx_group_sum``, :154) and then
runs the registered updater on the sum and the store's copy (:209);
``pull`` copies the store's value into every output (:233).  The store's
copy of a key is made where ``init`` was given it and moves, once, to
the device where its first sum lands, so the update on the store runs
beside the gradients (``Updater.state_for`` moves the optimizer's state
the same way).  With no updater the store keeps the sum itself as the
key's value, as the reference rebinds its handle: no copy, and for a
key pushed as one copy that copy's own tensor.

The bucketed round (:251-423) sums many keys at once: keys with several
copies are grouped into fixed-size buckets (``_plan_buckets``,
``MXNET_KVSTORE_BUCKET_BYTES``, default 4 MiB, read at import;
:func:`refresh_from_env` reads it again), homogeneous in dtype, copy
count and the first copy's context, and each bucket is summed as one
flat payload (``_bucket_reduce``: flatten, concatenate, one sum, split).
A bucket of one tensor larger than a chunk sums chunk by chunk
(``parallel.collective.chunked_reduce``).  Every sum adds the copies in
their order, so the bucketed round equals the per-key one bit for bit.
``reduce_scatter_all`` leaves each reduced value as row blocks on the
contexts its sharding names (:class:`RowShards`); ``all_gather_all``
joins them again on their home context.

Counters (``profiler``), as the JAX package books them: ``kvstore_push``
a key pushed, ``kvstore_pull`` a copy pulled, ``program_calls`` a sum of
several copies, a chunk of a chunked sum and a copy pulled,
``kvstore_bucket_reduce`` a bucket, ``kvstore_reduce_scatter`` a
reduce-scatter round.  A pull into the tensor the store holds (a key
pushed as one copy and pulled back into it, as Gluon's ``Trainer`` does)
copies nothing and counts no program.

Every store here lives in one process, as ``local`` and ``device`` do in
the JAX package: ``dist_*`` without a launcher (``DMLC_ROLE`` unset) has
the same semantics at rank 0 of 1.  A launched distributed store
(``KVStoreDist``) raises, naming ROADMAP A.10; ``tpu`` raises, since
this package has no TPU.  Gradient compression is not in the reference
revision and raises ``NotImplementedError`` there too.
"""
from __future__ import annotations

import os

import torch

from .base import MXNetError, dtype_name
from . import _pickle
from . import optimizer as opt
from . import profiler
from .ndarray import NDArray
from .parallel import collective
from .stream import open_stream

__all__ = ["KVStore", "RowShards", "create", "refresh_from_env"]

_DEFAULT_BUCKET_BYTES = 4 << 20


def _env_bucket_bytes():
    try:
        return max(1, int(os.environ.get("MXNET_KVSTORE_BUCKET_BYTES",
                                         _DEFAULT_BUCKET_BYTES)))
    except ValueError:
        return _DEFAULT_BUCKET_BYTES


_BUCKET_BYTES = _env_bucket_bytes()


def refresh_from_env():
    """Read ``MXNET_KVSTORE_BUCKET_BYTES`` again."""
    global _BUCKET_BYTES
    _BUCKET_BYTES = _env_bucket_bytes()


def _nbytes(arr):
    return arr._data.numel() * arr._data.element_size()


def _plan_buckets(metas, limit=None):
    """Greedy fixed-size buckets over ``metas``, a list of ``(group_key,
    nbytes)`` in slot order: each bucket holds slots of one group key, in
    their order, and no more than ``limit`` bytes unless it holds one
    slot.  Returns the buckets as lists of slot indices."""
    limit = limit or _BUCKET_BYTES
    open_buckets = {}  # group key -> [indices, bytes]
    plan = []
    for i, (gk, nbytes) in enumerate(metas):
        cur = open_buckets.get(gk)
        if cur is None or (cur[1] + nbytes > limit and cur[0]):
            cur = [[], 0]
            open_buckets[gk] = cur
            plan.append(cur)
        cur[0].append(i)
        cur[1] += nbytes
    return [b[0] for b in plan]


def _bucket_reduce(copies, device):
    """One bucket's sum: ``copies[j][i]`` is copy j of the bucket's key i
    (tensors); each copy's keys are flattened and joined on ``device``,
    the copies summed, and the sum split back into the keys' shapes."""
    flats = [torch.cat([a.reshape(-1).to(device) for a in copy])
             for copy in copies]
    total = collective.sum_copies(flats)
    outs, off = [], 0
    for a in copies[0]:
        n = a.numel()
        outs.append(total[off:off + n].view(a.shape))
        off += n
    return outs


def _ctx_group_sum(vals):
    """The sum of a list of NDArrays on the first one's device."""
    if len(vals) == 1:
        return vals[0]
    dev = vals[0]._data.device
    total = collective.sum_copies([v._data.to(dev) for v in vals])
    return NDArray(total, vals[0].context)


def _key_list(key, vals):
    if isinstance(key, (str, int)):
        return [key], [vals]
    if len(key) != len(vals):
        raise MXNetError("%d keys and %d values" % (len(key), len(vals)))
    return list(key), list(vals)


def _updater_key(k):
    """An updater is keyed by int where the key is one (the slot), else by
    the name (``mxnet_tpu/kvstore.py:904``)."""
    try:
        return int(k)
    except ValueError:
        return k


class RowShards:
    """A value split by rows over contexts: what ``reduce_scatter_all``
    leaves of a key whose sharding names contexts.  ``shards[i]`` holds
    the i-th equal block of rows on ``contexts[i]``; ``context`` is the
    home context (the first copy's), where ``all_gather_all`` joins
    them."""

    def __init__(self, shards, contexts, home):
        self.shards, self.contexts, self.context = shards, contexts, home

    def asnumpy(self):
        """The whole value on the host (bfloat16 as float32, exactly)."""
        return NDArray(torch.cat([s._data.detach().cpu()
                                  for s in self.shards]), None).asnumpy()


class KVStore:
    """A store in one process with the reference's push and pull."""

    def __init__(self, kind="local"):
        self._kind = kind
        self._store = {}  # key -> NDArray, the store's copy
        self._updater = None
        self._barrier_count = 0

    @property
    def type(self):
        return self._kind

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def init(self, key, value):
        """Give each key its first value (of a list of copies, the first);
        a key can be initialized once."""
        keys, vals = _key_list(key, value)
        for k, v in zip(keys, vals):
            if isinstance(v, (list, tuple)):
                v = v[0]
            if str(k) in self._store:
                raise MXNetError("key %s already initialized" % k)
            self._store[str(k)] = NDArray(v._data.detach().clone(),
                                          v.context)

    def _checked_key(self, k):
        k = str(k)
        if k not in self._store:
            raise MXNetError("key %s not initialized" % k)
        return k

    def _post_reduce(self, k, reduced):
        """After the sum of key ``k``: the updater on the sum and the
        store's copy, or the sum kept as the key's value."""
        held = self._store[k]
        if self._updater is None:
            self._store[k] = NDArray(reduced._data.to(held._data.dtype),
                                     reduced.context)
            return
        if held._data.device != reduced._data.device:
            self._store[k] = held = NDArray(
                held._data.to(reduced._data.device), reduced.context)
        self._updater(_updater_key(k), reduced, held)

    def push(self, key, value, priority=0):
        """Sum each key's copies and hand the sum to the store."""
        keys, vals = _key_list(key, value)
        for k, v in zip(keys, vals):
            k = self._checked_key(k)
            vlist = list(v) if isinstance(v, (list, tuple)) else [v]
            profiler.bump("kvstore_push")
            if len(vlist) > 1:
                profiler.bump("program_calls")
            self._post_reduce(k, _ctx_group_sum(vlist))

    def pull(self, key, out=None, priority=0, row_ids=None,
             ignore_sparse=True):
        """Copy each key's stored value into every one of its outputs."""
        if out is None:
            raise MXNetError("pull needs out")
        keys, outs = _key_list(key, out)
        for k, o in zip(keys, outs):
            k = self._checked_key(k)
            src = self._store[k]._data
            for dst in (o if isinstance(o, (list, tuple)) else [o]):
                profiler.bump("kvstore_pull")
                if dst._data is not src:
                    profiler.bump("program_calls")
                    dst._set_data(src)

    # -- the bucketed round ------------------------------------------------
    def _normalize_all(self, keys, values):
        if len(keys) != len(values):
            raise MXNetError("%d keys and %d values"
                             % (len(keys), len(values)))
        skeys = [self._checked_key(k) for k in keys]
        vlists = [list(v) if isinstance(v, (list, tuple)) else [v]
                  for v in values]
        return skeys, vlists

    def _reduce_all(self, vlists):
        """Every key's sum: a key of one copy is that copy; keys of several
        are summed a bucket at a time, bit for bit as the per-key sum."""
        reduced = [v[0] if len(v) == 1 else None for v in vlists]
        multi = [i for i, v in enumerate(vlists) if len(v) > 1]
        if not multi:
            return reduced
        metas = [((dtype_name(vlists[i][0]._data.dtype), len(vlists[i]),
                   vlists[i][0].context), _nbytes(vlists[i][0]))
                 for i in multi]
        for bucket in _plan_buckets(metas):
            idxs = [multi[b] for b in bucket]
            head = vlists[idxs[0]][0]
            dev = head._data.device
            copies = [[vlists[i][j]._data for i in idxs]
                      for j in range(len(vlists[idxs[0]]))]
            profiler.bump("kvstore_bucket_reduce")
            nbytes = sum(metas[b][1] for b in bucket)
            if len(idxs) == 1 and nbytes > collective.chunk_bytes():
                flat = collective.chunked_reduce(
                    [c[0].reshape(-1).to(dev) for c in copies])
                outs = [flat.view(head.shape)]
            else:
                profiler.bump("program_calls")
                outs = _bucket_reduce(copies, dev)
            for i, o in zip(idxs, outs):
                reduced[i] = NDArray(o, vlists[i][0].context)
        return reduced

    def push_all(self, keys, values, priority=0):
        """``push`` of every key, the sums made a bucket at a time."""
        skeys, vlists = self._normalize_all(keys, values)
        for k, r in zip(skeys, self._reduce_all(vlists)):
            profiler.bump("kvstore_push")
            self._post_reduce(k, r)

    def pull_all(self, keys, outs, priority=0):
        """``pull`` of every key."""
        if len(keys) != len(outs):
            raise MXNetError("%d keys and %d outs" % (len(keys), len(outs)))
        for k, o in zip(keys, outs):
            self.pull(k, out=o, priority=priority)

    def push_pull_all(self, keys, values, outs=None, priority=0):
        """The bucketed sum of every key and its broadcast: returns the
        reduced NDArrays (a key of one copy: that copy) and copies them
        into ``outs`` where given.  With an updater each key's sum goes
        through it and the store's copies are returned."""
        skeys, vlists = self._normalize_all(keys, values)
        reduced = self._reduce_all(vlists)
        results = []
        for k, r in zip(skeys, reduced):
            self._post_reduce(k, r)
            results.append(self._store[k] if self._updater is not None
                           else r)
        if outs is not None:
            for r, o in zip(results, outs):
                for dst in (o if isinstance(o, (list, tuple)) else [o]):
                    if dst is not r:
                        profiler.bump("kvstore_pull")
                        profiler.bump("program_calls")
                        dst._set_data(r._data)
        return results

    def reduce_scatter_all(self, keys, values, shardings, priority=0):
        """The bucketed sum of every key, each left as row blocks on the
        contexts of ``shardings[i]`` (a list of contexts over which the
        leading dim divides evenly, :class:`RowShards`), or where it
        landed where that is None.  The store's copies are not written."""
        skeys, vlists = self._normalize_all(keys, values)
        if len(shardings) != len(skeys):
            raise MXNetError("%d keys and %d shardings"
                             % (len(skeys), len(shardings)))
        reduced = self._reduce_all(vlists)
        profiler.bump("kvstore_reduce_scatter")
        placed = []
        for r, ctxs in zip(reduced, shardings):
            if ctxs is None:
                placed.append(r)
                continue
            rows = r.shape[0] if r.shape else 0
            if not rows or rows % len(ctxs):
                raise MXNetError("a leading dim of %s does not split over "
                                 "%d contexts" % (rows, len(ctxs)))
            per = rows // len(ctxs)
            placed.append(RowShards(
                [NDArray(r._data[i * per:(i + 1) * per]
                         .to(c.torch_device, copy=True), c)
                 for i, c in enumerate(ctxs)], list(ctxs), r.context))
        return placed

    def all_gather_all(self, keys, values, priority=0):
        """Each key's value whole on its own context, as a new NDArray
        (:class:`RowShards` joined; an NDArray as it is)."""
        skeys, vlists = self._normalize_all(keys, values)
        outs = []
        for v in (vl[0] for vl in vlists):
            profiler.bump("kvstore_pull")
            if isinstance(v, RowShards):
                dev = v.context.torch_device
                outs.append(NDArray(collective.gather_home(
                    [s._data for s in v.shards], dev), v.context))
            else:
                outs.append(NDArray(v._data, v.context))
        return outs

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` of each key (reference
        ``kvstore.py:227``; the JAX package's ``:424-446``): the other rows
        of each output become zeros, written into the output's own tensor
        in place (dense-backed, as in the reference).  Each output is
        tagged ``row_sparse``, and a ``RowSparseNDArray`` output keeps
        ``row_ids`` and their rows as its indices and values."""
        from .ndarray.sparse import RowSparseNDArray
        if out is None or row_ids is None:
            raise MXNetError("row_sparse_pull needs out and row_ids")
        keys, outs = _key_list(key, out)
        if isinstance(row_ids, NDArray):
            row_ids = [row_ids] * len(keys)
        for k, o, rid in zip(keys, outs, row_ids):
            src = self._store[self._checked_key(k)]._data
            rows = rid._data.to(src.device).long()
            picked = src.index_select(0, rows)
            for dst in (o if isinstance(o, (list, tuple)) else [o]):
                t = dst._data
                at = rows.to(t.device)
                with torch.no_grad():
                    t.zero_()
                    t[at] = picked.to(t.device, t.dtype)
                dst._stype = "row_sparse"
                if isinstance(dst, RowSparseNDArray):
                    dst._seed_sparse(at, t.index_select(0, at))

    # -- the update on the store -------------------------------------------
    def set_updater(self, updater):
        self._updater = updater

    def set_optimizer(self, optimizer):
        """Run ``optimizer`` on the store (the update-on-kvstore mode)."""
        self._updater = opt.get_updater(optimizer)

    def set_gradient_compression(self, compression_params):
        raise NotImplementedError(
            "gradient compression is not present in the reference revision")

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise AssertionError("Cannot save states for distributed "
                                 "training")
        with open_stream(fname, "wb") as fout:
            fout.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise AssertionError("Cannot load states for distributed "
                                 "training")
        with open_stream(fname, "rb") as fin:
            self._updater.set_states(fin.read())

    def get_checkpoint_state(self):
        """The store's optimizer states with the update counts, as bytes
        (None without an updater)."""
        if self._updater is None:
            return None
        counts = num_update = None
        srv = getattr(self._updater, "optimizer", None)
        if srv is not None:
            counts = dict(srv._index_update_count)
            num_update = int(srv.num_update)
        return _pickle.dumps({
            "updater": self._updater.get_states(dump_optimizer=False),
            "index_update_count": counts, "num_update": num_update})

    def set_checkpoint_state(self, blob):
        if blob is None:
            return
        if self._updater is None:
            raise AssertionError("restoring kvstore optimizer state needs an "
                                 "updater installed")
        payload = _pickle.loads(blob)
        self._updater.set_states(payload["updater"])
        srv = getattr(self._updater, "optimizer", None)
        if srv is not None and payload.get("index_update_count") is not None:
            srv._index_update_count = dict(payload["index_update_count"])
            srv.num_update = int(payload["num_update"])

    def barrier(self):
        self._barrier_count += 1

    def get_num_dead_node(self, node_id=0, timeout=60):
        """A store in one process has no peer to lose: 0."""
        return 0


def create(name="local"):
    """A store by name (``mxnet_tpu/kvstore.py:885-901``)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in ("local", "local_allreduce_cpu", "local_allreduce_device",
                "device"):
        return KVStore(name)
    if name == "tpu":
        raise MXNetError("kvstore 'tpu': this package runs on CUDA cards and "
                         "has no TPU mesh; use 'device'")
    if name.startswith("dist"):
        if "DMLC_ROLE" not in os.environ:
            # no launcher: one worker, the same semantics as a local store
            return KVStore(name)
        raise MXNetError(
            "kvstore %r with DMLC_ROLE=%s: the distributed store over worker "
            "and server processes (KVStoreDist, dist_ps.py) is not ported "
            "yet (ROADMAP A.10)" % (name, os.environ["DMLC_ROLE"]))
    raise MXNetError("unknown kvstore type %s" % name)
