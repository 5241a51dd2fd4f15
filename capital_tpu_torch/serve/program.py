"""A bucket's program: the counterpart of the reference engine's
``jax.jit(fn, donate_argnums=dn).lower(*specs).compile()``
(capital_tpu/serve/engine.py `_get_batched`), and the rules that resolve
it.

On the card a capturable bucket's program is one CUDA graph, captured
once when the program is built:

1. static inputs of shape ``(capacity, *a_shape)`` (and
   ``(capacity, *b_shape)``) in the bucket's dtype, filled with
   `batching.fill_problem`'s identity problems;
2. one eager call of the bucket's `api.batched` program on them, on a side
   stream: it builds the nvcc kernels at their first use and warms the
   allocator and the library handles, none of which may happen inside a
   capture;
3. the capture of a second call into static outputs.

Calling the program copies the assembled batch into the static inputs,
replays the graph and clones the outputs, all on the caller's stream and
without a host sync.  The clone keeps a second in-flight batch of the same
bucket from overwriting the first one's results.  The launch counters
(`hopper.KERNELS`) count in the Python wrappers, which run at capture and
not at a replay: the program keeps what its capture launched
(`capture_counts`, `capture_routes`) and counts its own calls (`replays`).

Elsewhere — on the CPU, and for buckets `capturable` rules eager — the
program is the plain closure, called as it stands.  A capture that fails
raises: nothing falls back to the eager program.

Donation (`donate_argnums`, the reference's rule in serve/executor.py):
the program writes its primary output into the named input's buffer and
returns that buffer, in place of a fresh clone.  `check_donation` is the
alias check `SolveEngine(validate=True)` runs at cache insert.
"""

from __future__ import annotations

import torch

from capital_tpu_torch.models import blocktri
from capital_tpu_torch.ops import batched_small, blocktri_small, hopper, update_small
from capital_tpu_torch.robust import refine
from capital_tpu_torch.serve import batching

#: the chain ops: blocktri_small's gate resolves their route per scan step
_CHAIN_OPS = ("posv_blocktri", "posv_arrowhead", "blocktri_extend")


def small_route(bucket: batching.Bucket, cfg, *, interpret: bool) -> bool:
    """Whether this bucket's program runs the port's batched kernels (the
    reference's `SolveEngine._small_route`, the same static resolution
    `api.batched('auto')` makes at call time).  `interpret` is the grid's
    side of the envelope question (`api._host_side`): True on the CPU,
    where the plain versions have no envelope.

    posv_cached and its miss program resolve as posv at the same shapes;
    blocktri_extend as a chain scan step at k = b.  session_extend and
    session_solve resolve as the reference's engine resolves them: through
    batched_small's question, which answers the library route for every op
    but posv and lstsq, so under 'auto' they count as not small, although
    on the card their chain steps take the kernels (`blocktri_small`'s own
    gate) — the split is stats only, and it stays the reference's."""
    impl = cfg.small_n_impl
    if impl == "vmap":
        return False
    # tiered buckets factor at the plan's dtype, not the request's: a
    # guaranteed f64 bucket factors in f32 and can take the kernels
    dtype = batching._dtype(bucket.dtype)
    if bucket.tier != "balanced":
        dtype = refine.plan(bucket.tier, dtype).factor_dtype
    if not batched_small.dtype_capable(dtype):
        return False
    forced = impl in ("pallas", "pallas_split")
    if bucket.op in _CHAIN_OPS:
        if forced:
            return True
        _, nblocks, b, _ = bucket.a_shape
        seg = blocktri.resolve_seg(nblocks)
        if bucket.op == "posv_blocktri":
            k = bucket.b_shape[2]
        elif bucket.op == "posv_arrowhead":
            k = bucket.b_shape[1]
        else:
            k = b
        return blocktri_small.default_impl(b, k, seg, dtype, interpret=interpret) == "pallas"
    if bucket.op in batching.UPDATE_OPS:
        if forced:
            return True
        return update_small.default_impl(bucket.a_shape[0], bucket.b_shape[1], dtype,
                                         interpret=interpret) == "pallas"
    if forced:
        return True
    a_shape = (bucket.capacity,) + bucket.a_shape
    if bucket.op in ("posv_cached", "posv_cached_miss"):
        # potrs / potrf + potrs at posv's geometry: posv's question
        return batched_small.default_impl("posv", a_shape, (bucket.capacity,) + bucket.b_shape,
                                          dtype, interpret=interpret) == "pallas"
    if bucket.op == "inv":
        # inv rides the posv kernel with an identity RHS (api.batched)
        return batched_small.default_impl("posv", a_shape, a_shape, dtype,
                                          interpret=interpret) == "pallas"
    b_shape = (bucket.capacity,) + bucket.b_shape if bucket.b_shape is not None else None
    return batched_small.default_impl(bucket.op, a_shape, b_shape, dtype,
                                      interpret=interpret) == "pallas"


def blocktri_algorithm(nblocks: int, dtype, cfg) -> str:
    """Which chain algorithm a posv_blocktri / posv_arrowhead bucket
    program runs — 'scan' or 'partitioned' — from the same static
    resolution `api._batched_blocktri` makes (the reference's
    `SolveEngine._blocktri_algorithm`)."""
    dtype = batching._dtype(str(dtype).replace("torch.", ""))
    if cfg.blocktri_impl == "partitioned":
        return blocktri.posv_algorithm(nblocks, dtype, impl="partitioned",
                                       partitions=cfg.blocktri_partitions)
    if cfg.blocktri_impl == "scan" or cfg.small_n_impl != "auto":
        # a forced kernel flavor pins the sequential program under
        # blocktri_impl='auto' (api._batched_blocktri)
        return "scan"
    return blocktri.posv_algorithm(nblocks, dtype, partitions=cfg.blocktri_partitions)


#: the ops whose bucket programs capture on the card: every op with a
#: bucket program (`capturable`)
CAPTURED_OPS = (batching.DENSE_OPS + batching.STRUCTURED_OPS + batching.UPDATE_OPS
                + ("posv_cached",) + batching.MISS_OPS + ("blocktri_extend",)
                + batching.SESSION_BUCKET_OPS)


def capturable(bucket: batching.Bucket, cfg) -> bool:
    """Whether the bucket's program is captured as a CUDA graph on the card:
    a pure function of the resolved bucket, never decided by trying a
    capture (a capture that fails raises).

    Every bucket program captures, whatever its dtype, tier, route
    (`small_route`) and chain algorithm.  `probes/serve_capture.py` asked
    the card for every combination of op x dtype (f32, f64, bf16) x
    small_n_impl x chain algorithm x tier x capacity (1, 8): each
    captured, and each replay was bit for bit the eager program's — the
    residency and session programs too (202 of 202 combinations of
    posv_cached, posv_cached_miss with its three outputs, blocktri_extend,
    session_extend, session_solve in all three tiers with the guaranteed
    tier's five outputs, and chol_downdate, H100 80GB HBM3 at 700 W).  None
    of the programs syncs with the host: the port's kernels are launched
    through ctypes on the current stream, the refinement loop runs its
    sweep cap with the freeze mask on the device, and the library routes'
    `torch.linalg` calls (cuSOLVER's potrf, batched and single-matrix,
    cuBLAS's triangular solves and products) queue without a host
    round trip — `cholesky_ex` and `solve_triangular` check no errors on
    the host.  So the answer depends on the op alone: the ops with a
    bucket program (`CAPTURED_OPS`); `cfg` is taken for the signature the
    engine calls it with."""
    del cfg
    return bucket.op in CAPTURED_OPS


def _diff(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


class Program:
    """One bucket's built program (module docstring).  `fn` is the
    bucket's `api.batched` program; `capture` asks for the CUDA graph
    (`capturable`, on a CUDA `device` only)."""

    def __init__(self, fn, bucket: batching.Bucket, device, *, capture: bool,
                 donate_argnums: tuple[int, ...] = ()):
        self.fn = fn
        self.bucket = bucket
        self.device = torch.device(device)
        self.donate_argnums = tuple(donate_argnums)
        self.replays = 0
        #: kernel launches and route tallies the capture made (the plan
        #: every replay runs); empty for an eager program
        self.capture_counts: dict[str, int] = {}
        self.capture_routes: dict[str, dict[str, int]] = {}
        self._graph = None
        self._static_in: tuple = ()
        self._static_out: tuple = ()
        if capture:
            if self.device.type != "cuda":
                raise ValueError(f"a program is captured on a CUDA device, not {self.device}")
            self._capture()

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def fill_inputs(self) -> tuple:
        """The bucket's batch of fill problems, one fresh stack per operand."""
        fa, fb = batching.fill_problem(self.bucket, device=self.device)
        cap = self.bucket.capacity
        ins = [fa.expand(cap, *fa.shape).clone()]
        if fb is not None:
            ins.append(fb.expand(cap, *fb.shape).clone())
        return tuple(ins)

    def _capture(self) -> None:
        ins = self.fill_inputs()
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            self.fn(*ins)
        stream.wait_stream(side)
        counts, routes = hopper.counts(), hopper.route_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = tuple(self.fn(*ins))
        self.capture_counts = _diff(hopper.counts(), counts)
        after = hopper.route_counts()
        self.capture_routes = {k: d for k, v in after.items()
                               if (d := _diff(v, routes.get(k, {})))}
        self._graph, self._static_in, self._static_out = graph, ins, outs

    def _donated(self, args, x):
        """The donated input's buffer holding `x`, or None where the
        declaration cannot be honored (no donation, or `x` differs from the
        input in shape or dtype: the reference's dropped donation)."""
        if not self.donate_argnums:
            return None
        d = args[self.donate_argnums[0]]
        if d.shape != x.shape or d.dtype != x.dtype:
            return None
        return d.copy_(x)

    def _run(self, args) -> tuple:
        if self._graph is None:
            outs = tuple(self.fn(*args))
            fresh = outs
        else:
            for s, a in zip(self._static_in, args):
                s.copy_(a)
            self._graph.replay()
            outs = self._static_out
            fresh = None
        head = self._donated(args, outs[0])
        if fresh is not None:
            return outs if head is None else (head,) + outs[1:]
        if head is None:
            return tuple(o.clone() for o in outs)
        return (head,) + tuple(o.clone() for o in outs[1:])

    def __call__(self, *args) -> tuple:
        self.replays += 1
        return self._run(args)

    def check_donation(self) -> list[str]:
        """Problems of the declared donation ([] = honored): one call on a
        fill batch, whose primary output must live in the donated input's
        buffer (by `data_ptr`).  Not counted in `replays`."""
        if not self.donate_argnums:
            return []
        ins = self.fill_inputs()
        out = self._run(ins)[0]
        dn = self.donate_argnums[0]
        if out.data_ptr() != ins[dn].data_ptr():
            return [f"{batching.bucket_label(self.bucket)}: argument {dn} {tuple(ins[dn].shape)} "
                    f"declared donated, but the primary output {tuple(out.shape)} is a fresh buffer"]
        return []
