"""Run a test function of the reference package's suites twice - once on
the reference, once on the port - and compare everything both runs left
behind, exactly.

The reference suites (``tests/test_pim_runtime.py``, ``test_faults.py``,
...) call their package through module-level names (``AmbitRuntime``,
``BitVector``, ``FaultInjector``, ...). ``dual`` copies a suite module's
namespace, binds those names to the port (``device="cpu"``, the
reference's ``"jnp"``/``"pallas"`` backends mapped to ``"torch"``/
``"cuda"``), rebinds every function of the module to the copy and runs
the requested test. Imports inside a test body (``from repro.x import
y``) resolve to ``repro_torch.x`` during the port's run. Both runs start
from the same fresh module-level random generators, so they see the same
bits.

Every runtime, store, cluster, device, fault injector, frontend and ticket
a run creates is tracked; afterwards its state is fingerprinted: the
metrics snapshot, session and last-call ``OpStats``, drain and epoch
reports, planner and optimizer reports, the channel ledger, the fault
ledger string, every tracked ticket, every frontend record and report,
and the placement and DRAM-row contents of every handle still registered
in a store. The two fingerprints must be equal with no tolerance: the
reference is integer arithmetic, and its float ledger tokens are sums
taken in the same order in both packages.

This module is a helper of the ``tests/test_torch_*.py`` files; pytest
does not collect it.
"""

from __future__ import annotations

import builtins
import contextlib
import dataclasses
import importlib
import sys
import types

import numpy as np
import torch

import repro.core as J
import repro.core.engine as jengine
import repro.pim as JP
import repro.pim.faults as jfaults
import repro.pim.optimizer as jopt
import repro.serve as JS
import repro_torch.core as T
import repro_torch.core.analog  # noqa: F401  (T.analog)
import repro_torch.core.ecc  # noqa: F401  (T.ecc)
import repro_torch.core.engine as tengine
import repro_torch.pim as TP
import repro_torch.pim.faults as tfaults
import repro_torch.pim.optimizer as topt
import repro_torch.serve as TS

BACKEND_MAP = {"jnp": "torch", "pallas": "cuda"}
# module-level random generators of the suites, by their seeds
RNG_SEEDS = {"test_pim_runtime": 11, "test_pim_cluster": 29,
             "test_optimizer": 11, "test_scheduler": 23,
             "test_backend_matrix": 17, "test_apps": 0}


class Tracker:
    """Everything one run created, in creation order."""

    def __init__(self):
        self.objs = []          # (kind, object)
        self.tickets = []

    def add(self, kind, obj):
        self.objs.append((kind, obj))
        return obj


# -- the two packages' names, with tracking -----------------------------------


def _names(pkg: str, tr: Tracker) -> dict:
    """Module-level names the suites use, bound to ``pkg`` ("ref" or
    "port")."""
    port = pkg == "port"
    core, pim, serve = (T, TP, TS) if port else (J, JP, JS)
    faults = tfaults if port else jfaults
    opt = topt if port else jopt
    engine_mod = tengine if port else jengine
    cpu = {"device": "cpu"} if port else {}

    class Runtime(pim.AmbitRuntime):
        def __init__(self, *a, **kw):
            if port:
                kw["backend"] = BACKEND_MAP.get(kw.get("backend"),
                                                kw.get("backend",
                                                       "ambit_sim"))
                kw.setdefault("device", "cpu")
            super().__init__(*a, **kw)
            tr.add("runtime", self)

        def submit(self, *a, **kw):
            t = super().submit(*a, **kw)
            tr.tickets.append(t)
            return t

    class Store(pim.PimStore):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            tr.add("store", self)

    class Cluster(pim.PimCluster):
        def __init__(self, *a, **kw):
            kw.update(cpu)
            super().__init__(*a, **kw)
            tr.add("store", self)

    class Device(core.AmbitDevice):
        def __init__(self, *a, **kw):
            kw.update(cpu)
            super().__init__(*a, **kw)
            tr.add("device", self)

    class Injector(faults.FaultInjector):
        def __init__(self, *a, **kw):
            kw.update(cpu)
            super().__init__(*a, **kw)
            tr.add("injector", self)

    class Frontend(serve.QueryFrontend):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            tr.add("frontend", self)

    def Engine(backend="jnp" if not port else "torch", *a, **kw):
        if port:
            backend = BACKEND_MAP.get(backend, backend)
            kw.setdefault("device", "cpu")
        return engine_mod.BulkBitwiseEngine(backend, *a, **kw)

    class BV(core.BitVector):
        @staticmethod
        def from_bits(bits, **kw):
            kw.update(cpu)
            return core.BitVector.from_bits(bits, **kw)

        @staticmethod
        def zeros(n_bits, rows=(), **kw):
            kw.update(cpu)
            return core.BitVector.zeros(n_bits, rows, **kw)

        @staticmethod
        def ones(n_bits, rows=(), **kw):
            kw.update(cpu)
            return core.BitVector.ones(n_bits, rows, **kw)

    names = {
        "AmbitRuntime": Runtime, "PimStore": Store, "PimCluster": Cluster,
        "AmbitDevice": Device, "FaultInjector": Injector,
        "QueryFrontend": Frontend, "BulkBitwiseEngine": Engine,
        "BitVector": BV,
        "AmbitError": core.AmbitError, "DRAMGeometry": core.DRAMGeometry,
        "Expr": core.Expr, "maj": core.maj, "E": core.expr,
        "OpStats": engine_mod.OpStats,
        "RowAllocator": pim.RowAllocator,
        "COLOCATED": pim.COLOCATED, "STRIPED": pim.STRIPED,
        "AFFINITY": pim.AFFINITY, "PACKED": pim.PACKED,
        "ROUND_ROBIN": pim.ROUND_ROBIN,
        "CLUSTER_POLICIES": pim.CLUSTER_POLICIES,
        "ChannelModel": pim.ChannelModel,
        "FaultConfig": faults.FaultConfig, "FaultError": faults.FaultError,
        "ReliabilityManager": faults.ReliabilityManager,
        "TenantQuota": serve.TenantQuota,
        "run_closed_loop": serve.run_closed_loop,
        "canonicalize": opt.canonicalize, "n_ops": opt.n_ops,
        "struct_key": opt.struct_key,
        "QueryOptimizer": opt.QueryOptimizer,
        "TMRCodec": core.ecc.TMRCodec if port else _jecc().TMRCodec,
    }
    if port:
        names["jnp"] = np           # jnp.asarray(numpy bits) in helpers
        names["tra_failure_rate"] = _cpu(T.analog.tra_failure_rate)
    return names


def _cpu(fn):
    def call(*a, **kw):
        kw.setdefault("device", "cpu")
        return fn(*a, **kw)
    return call


def _jecc():
    import repro.core.ecc as jecc
    return jecc


# -- run one suite function in one package ------------------------------------


def _port_exprs(v, memo):
    """Module-level reference ``Expr`` constants (alone or in lists,
    tuples and dicts) rebuilt as the port's interned nodes."""
    if isinstance(v, J.Expr):
        e = memo.get(id(v))
        if e is None:
            e = T.Expr(v.op, tuple(_port_exprs(a, memo) for a in v.args),
                       v.name)
            memo[id(v)] = e
        return e
    if isinstance(v, (list, tuple)):
        return type(v)(_port_exprs(x, memo) for x in v)
    if isinstance(v, dict):
        return {k: _port_exprs(x, memo) for k, x in v.items()}
    return v


def _rebound(module, names: dict, port: bool) -> dict:
    """A copy of ``module``'s namespace with ``names`` overridden, its
    expression constants in the package's own ``Expr`` nodes, and every
    function of the module rebound to the copy."""
    g = dict(module.__dict__)
    if port:
        memo = {}
        for k, v in list(g.items()):
            if not k.startswith("__"):
                g[k] = _port_exprs(v, memo)
    g.update({k: v for k, v in names.items() if k in g or k == "jnp"})
    seed = RNG_SEEDS.get(module.__name__)
    old_rng = g.get("RNG")
    if seed is not None:
        g["RNG"] = np.random.default_rng(seed)
    for k, v in list(g.items()):
        if isinstance(v, types.FunctionType) and \
                v.__globals__ is module.__dict__:
            defaults = v.__defaults__ and tuple(   # rng=RNG defaults too
                g["RNG"] if d is old_rng and old_rng is not None else d
                for d in v.__defaults__)
            f = types.FunctionType(v.__code__, g, v.__name__,
                                   defaults, v.__closure__)
            f.__kwdefaults__ = v.__kwdefaults__
            f.__dict__.update(v.__dict__)
            g[k] = f
    return g


class _Module(types.ModuleType):
    """A package module whose names the suites bind differently (tracking;
    on the port the CPU device and backend names) read through
    ``names``."""

    def __init__(self, mod, names):
        super().__init__(mod.__name__)
        self._mod, self._names = mod, names

    def __getattr__(self, k):
        if k in self._names:
            return self._names[k]
        return getattr(self._mod, k)


@contextlib.contextmanager
def _imports_to(top: str, names: dict):
    """``from repro.x import y`` inside a test body -> ``y`` of ``top.x``
    (``repro_torch`` on the port), with ``names`` overriding."""
    real = builtins.__import__

    def imp(name, globals=None, locals=None, fromlist=(), level=0):
        if level == 0 and (name == "repro" or name.startswith("repro.")):
            mod = importlib.import_module(top + name[5:])
            if fromlist:
                return _Module(mod, names)
            return importlib.import_module(top)
        return real(name, globals, locals, fromlist, level)

    builtins.__import__ = imp
    try:
        yield
    finally:
        builtins.__import__ = real


class Lazy:
    """An argument built inside each run from the run's own names, e.g.
    ``Lazy("BulkBitwiseEngine", "ambit_sim")`` for an ``engine`` fixture."""

    def __init__(self, name, *args, **kwargs):
        self.name, self.args, self.kwargs = name, args, kwargs

    def make(self, g):
        return g[self.name](*self.args, **self.kwargs)


def run(module, fn_name: str, pkg: str, *args, **kwargs):
    """Run ``module.fn_name(*args)`` on ``pkg``; returns its fingerprint."""
    tr = Tracker()
    names = _names(pkg, tr)
    g = _rebound(module, names, pkg == "port")
    with _imports_to("repro_torch" if pkg == "port" else "repro", names):
        args = [a.make(g) if isinstance(a, Lazy) else a for a in args]
        g[fn_name](*args, **kwargs)
    return fingerprint(tr)


def dual(module, fn_name: str, *args, **kwargs):
    """Run on both packages and require equal fingerprints."""
    if isinstance(module, str):
        module = sys.modules.get(module) or importlib.import_module(module)
    want = run(module, fn_name, "ref", *args, **kwargs)
    got = run(module, fn_name, "port", *args, **kwargs)
    assert_same(got, want)
    return got


def assert_same(got, want, path="fp"):
    """Equal fingerprints; on a difference, name its first path."""
    if isinstance(want, (list, tuple)) and isinstance(got, (list, tuple)):
        assert len(got) == len(want), (path, len(got), len(want))
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{path}[{i}]")
        return
    if isinstance(want, dict) and isinstance(got, dict):
        assert sorted(got, key=repr) == sorted(want, key=repr), (
            path, sorted(set(got) ^ set(want), key=repr))
        for k in want:
            assert_same(got[k], want[k], f"{path}[{k!r}]")
        return
    assert got == want, (path, got, want)


def ledger(_name, _text):
    """Stand-in for the suites' ``record_ledger`` fixture."""


def case_id(case):
    """A stable test id: the function name and its plain arguments."""
    parts = [getattr(c, "__name__", None) if not isinstance(
        c, (str, int)) else str(c) for c in case]
    return "-".join(p for p in parts if p and p != "ledger")


# -- fingerprints -------------------------------------------------------------


def words(x):
    """Packed words (numpy, jax or torch) -> (bit width, shape, bytes)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    width = {1: 8, 4: 32, 8: 64}[a.dtype.itemsize] if a.dtype != bool \
        else 1
    return (width, tuple(a.shape), np.ascontiguousarray(a).tobytes())


def _dc(x):
    return dataclasses.astuple(x) if dataclasses.is_dataclass(x) else x


def _row_of(store, ds):
    """Raw DRAM row of one chunk (no ledger, no fault hook)."""
    if ds is None:
        return None
    if getattr(store, "devices", None) is not None:     # cluster
        d, (b, s, r) = ds
        dev = store.devices[d]
    else:
        dev, (b, s, r) = store.device, ds
    return words(dev.banks[b].subarrays[s].read_row(r))


def _handle(store, h):
    out = [h.name, h.n_bits, tuple(h.shape), h.dirty, h.pinned, h.spilled,
           bool(getattr(h, "protected", False)),
           bool(getattr(h, "lost", False))]
    if hasattr(h, "_dev"):                              # DeviceStore
        out.append(None if h._dev is None else words(h._dev))
    else:
        out.append([(ds, _row_of(store, ds)) for ds in h.slots])
        stash = getattr(h, "_stash", {})
        out.append(sorted((i, words(v)) for i, v in stash.items()))
    if h._host is not None:
        out.append(words(h._host.data))
    return out


def _store_fp(store):
    fp = {k: getattr(store, k, None) for k in (
        "host_writes", "host_reads", "bytes_to_device", "bytes_from_device",
        "migrated_rows", "evicted_clean", "evicted_dirty", "pinned_bytes")}
    fp["ledger"] = _dc(getattr(store, "ledger", None))
    fp["dead"] = sorted(getattr(store, "dead_devices", ()))
    allocs = getattr(store, "allocators", None) or (
        [store.allocator] if getattr(store, "allocator", None) is not None
        else [])
    fp["allocators"] = [a.report() for a in allocs]
    fp["handles"] = [_handle(store, h) for h in store._lru.values()]
    devs = getattr(store, "devices", None)
    if devs is None and hasattr(store, "allocator"):
        devs = [store.device]
    fp["devices"] = [_dc(d.total_stats()) for d in devs or ()]
    fp["metrics"] = store.metrics.snapshot()
    return fp


def _ticket_fp(t):
    res = t.result
    return [t.index, t.state, t.epoch, _dc(t.stats),
            sorted(t.resource_ns.items()), t.channel_ns, t.submitted_ns,
            t.started_ns, t.finished_ns, t.synthetic, t.cache_hit, t.error,
            t.retries, t.backoff_ns, list(t.deferred), repr(t.expression),
            repr(t.rewritten_from),
            None if res is None else (res.name, res.n_bits, res.freed)]


def _result_fp(r):
    if r is None:
        return None
    if hasattr(r, "data") and not hasattr(r, "slots"):  # a BitVector
        return ("bv", r.n_bits, words(r.data))
    return ("handle", r.name, r.n_bits, r.freed)


def fingerprint(tr: Tracker):
    out = []
    for kind, o in tr.objs:
        if kind == "runtime":
            sched = o.scheduler
            opt = sched._optimizer
            out.append(("runtime", {
                "session": _dc(o.session_stats),
                "last": _dc(o.last_stats), "clock": o.clock_ns,
                "drain": _dc(sched.last_drain), "drains": sched.drains,
                "plan": _dc(o.planner.last_report),
                "opt": None if opt is None else (
                    _dc(opt.last_report), len(opt.cache)),
                "store": _store_fp(o.store),
                "injector": None if o.fault_injector is None
                else o.fault_injector.ledger()}))
        elif kind == "store":
            out.append(("store", _store_fp(o)))
        elif kind == "device":
            out.append(("device", _dc(o.total_stats())))
        elif kind == "injector":
            out.append(("injector", o.ledger(), sorted(o.counts.items()),
                        sorted(o.dead)))
        elif kind == "frontend":
            out.append(("frontend", _dc(o.report()), [
                (q.seq, q.tenant, q.arrival_ns, q.admitted_ns,
                 q.finished_ns, q.error, q.timed_out, q.fallback,
                 None if q.ticket is None else q.ticket.index,
                 _result_fp(q.result)) for q in o.completed]))
    out.append(("tickets", [_ticket_fp(t) for t in tr.tickets]))
    return out
