#!/usr/bin/env python3
"""Which collectives this torch's gloo takes on CUDA tensors.

Runs each of ``all_reduce``, ``all_gather_into_tensor`` (or
``all_gather_single``), ``reduce_scatter_tensor`` (or
``reduce_scatter_single``), ``all_to_all_single`` and
``batch_isend_irecv`` on CUDA tensors over a gloo group of 2 ranks that
share the card, and checks the values that come back; an op that fails
(or kills a rank) stops the ranks, and the next op starts them again.  The same
ops on CPU tensors are checked too.  Prints one JSON line: ``{op: {"cuda":
"ok" | error, "cpu": ...}}``; ``collective.GLOO_CUDA_OPS`` lists the ops
that read "ok" on CUDA.  Run from the repository root on the card:

    python3 tools/torch_gloo_cuda_probe.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

OPS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
       "all_to_all_single", "batch_isend_irecv")


def probe(op, device):
    """``op`` on this rank's tensors on ``device``: "ok", or why not."""
    import torch
    import torch.distributed as dist
    r, n = dist.get_rank(), dist.get_world_size()
    dev = torch.device(device)
    x = torch.arange(4.0, device=dev) + 10 * r
    try:
        if op == "all_reduce":
            out = x.clone()
            dist.all_reduce(out)
            want = sum(torch.arange(4.0) + 10 * k for k in range(n))
        elif op == "all_gather_into_tensor":
            out = torch.empty(4 * n, device=dev)
            fn = getattr(dist, "all_gather_single", None) \
                or dist.all_gather_into_tensor
            fn(out, x)
            want = torch.cat([torch.arange(4.0) + 10 * k for k in range(n)])
        elif op == "reduce_scatter_tensor":
            out = torch.empty(4 // n, device=dev)
            fn = getattr(dist, "reduce_scatter_single", None) \
                or dist.reduce_scatter_tensor
            fn(out, x)
            want = sum(torch.arange(4.0) + 10 * k for k in range(n))
            want = want[r * (4 // n):(r + 1) * (4 // n)]
        elif op == "all_to_all_single":
            out = torch.empty(4, device=dev)
            dist.all_to_all_single(out, x)
            per = 4 // n
            want = torch.cat([(torch.arange(4.0) + 10 * k)[r * per:
                                                          (r + 1) * per]
                              for k in range(n)])
        else:
            out = torch.empty(4, device=dev)
            ops = [dist.P2POp(dist.isend, x, (r + 1) % n),
                   dist.P2POp(dist.irecv, out, (r - 1) % n)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
            want = torch.arange(4.0) + 10 * ((r - 1) % n)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if not torch.equal(out.cpu(), want):
            return "wrong values %s, want %s" % (out.tolist(), want.tolist())
        return "ok"
    except Exception as e:  # the probe reports what gloo refused
        return "%s: %s" % (type(e).__name__, str(e).splitlines()[0][:200])


def main():
    import torch
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.test_utils import RankPool
    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    out = {op: {} for op in OPS}
    for dev in devices:
        with RankPool(2, backend="gloo", device=dev, timeout=60) as pool:
            for op in OPS:
                try:
                    res = pool.run(probe, op, dev)
                    out[op][dev] = res[0] if res[0] == res[1] else res
                except MXNetError as e:  # a rank died: gloo refused the op
                    out[op][dev] = "rank failed: %s" % str(e).splitlines()[0]
    print(json.dumps({"torch": torch.__version__,
                      "gloo_collectives": out}), flush=True)


if __name__ == "__main__":
    main()
