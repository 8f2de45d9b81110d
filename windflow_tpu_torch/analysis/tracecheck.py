"""wfverify: object-level static verifier of the functions a graph runs
(the port of ``windflow_tpu/analysis/tracecheck.py``).

The preflight checker type-checks the dataflow on fake tensors; the
contracts that burn a run on the card — a host read inside a step a
CUDA graph captures, a per-call host value frozen into a captured
replay, a nondeterministic replay after a restore — show only after
dispatch.  This module is their static twin: it reads the **actual
function objects** handed to the operators (map/filter kernels, reduce
and window combiners, lifts, key extractors, a DeviceSource's batch
function, sink callbacks) and the port's own step bodies, through
``inspect`` and the AST with closure/``__globals__`` resolution and
bounded call-depth following, before any batch is staged.

The families (codes in ``analysis/diagnostics.py``), on a device
operator's callable ("traced": a megastep may capture it):

* **host reads and control flow (WF80x)** — ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float/int/bool(<tensor>)``,
  ``np.asarray(<tensor>)`` (WF801); ``if``/``while`` on a tensor
  (WF802); mutation of closure/global/default-arg state (WF803);
  ``print`` (WF804);
* **frozen values and dynamic shapes (WF81x)** — ``len()`` of a mutable
  closure container, ``next()``, a wall-clock read baked into a replay
  (WF811); ``nonzero``, ``unique``, ``masked_select``, boolean-mask
  indexing, one-argument ``torch.where``, ``repeat_interleave`` without
  ``output_size`` (WF812);
* **determinism for replay (WF61x)**, on every callable of a
  durability-enabled graph — ``torch.rand*``/``randint``/``randperm``/
  ``normal``/``bernoulli`` without ``generator=``, module-level
  ``np.random`` and ``random`` (WF611); wall clock (WF612);
  ``id()``/``hash()`` (WF613); set iteration order (WF614).

The donation family (WF821) has no counterpart: the port donates no
buffer (torch steps update their state in place and allocate their
outputs), so :class:`VerifyReport` says the family is not applicable,
as the sweep ledger's donation keys do.

Inline suppression, as in the JAX package: a ``# wfverify: ok
(reason)`` comment on the flagged line or within the two lines above
suppresses the finding; the reason is mandatory — a bare ``wfverify:
ok`` is rejected and the finding reported with a note.
"""

from __future__ import annotations

import ast
import functools
import inspect
import linecache
import os
import re
import time
import types
from typing import Any, Dict, List, Optional, Set, Tuple

from windflow_tpu_torch.analysis.diagnostics import Diagnostic

#: inline suppression token (reason mandatory, in parentheses)
SUPPRESS_TOKEN = "wfverify: ok"
_SUPPRESS_RE = re.compile(r"wfverify:\s*ok\s*\(\s*[^)\s][^)]*\)")

#: bounded interprocedural following: beyond this depth a callee is
#: treated as opaque
MAX_CALL_DEPTH = 3
#: the port's step bodies are followed one call deep: their helpers are
#: host-side plumbing (shape checks, launch return codes) a taint walk
#: cannot tell from device values
FRAMEWORK_DEPTH = 1

#: why the donation family never fires on the port
DONATION_NOTE = ("not applicable: torch steps update their state in "
                 "place and allocate their outputs, so no buffer is "
                 "donated")

#: attribute reads on a tensor that yield host metadata (legal to branch
#: on or read on the host), and the host fields of the port's batches
_STATIC_ATTRS = {"shape", "dtype", "ndim", "size", "nbytes", "itemsize",
                 "device", "is_cuda", "layout", "numel", "dim",
                 "element_size", "is_floating_point", "requires_grad",
                 "watermark", "frontier", "ts_max", "ts_min", "known_size",
                 "trace", "shared"}

#: builtins whose result is static even over tensor arguments
_STATIC_FNS = {"len", "isinstance", "issubclass", "hasattr", "getattr",
               "callable", "type", "repr", "str", "format", "dir"}

#: receiver roots of the torch namespace (a torch call on a tensor stays
#: on the card)
_TORCH_ROOTS = {"torch", "F"}

#: method names that mutate their receiver in place
_MUTATORS = {"append", "extend", "insert", "remove", "pop", "clear",
             "add", "discard", "update", "setdefault", "popitem",
             "appendleft", "extendleft", "sort", "reverse"}

#: host reads of a tensor (WF801), as methods and as casts
_HOST_READS = {"item", "tolist", "cpu", "numpy"}
_HOST_CASTS = {"float", "int", "bool", "complex"}

#: data-dependent output shapes (WF812) when fed tensors
_SHAPE_DYNAMIC = {"nonzero", "argwhere", "unique", "unique_consecutive",
                  "masked_select", "flatnonzero"}

#: torch draws from the global generator unless ``generator=`` is given
_TORCH_RNG = {"rand", "rand_like", "randn", "randn_like", "randint",
              "randint_like", "randperm", "normal", "bernoulli",
              "multinomial", "poisson"}

_WALLCLOCK_TIME_ATTRS = {"time", "time_ns", "monotonic", "monotonic_ns",
                         "perf_counter", "perf_counter_ns", "clock_gettime"}
_WALLCLOCK_DT_ATTRS = {"now", "utcnow", "today"}

_MUTABLE_CONTAINERS = (list, dict, set, bytearray)


# ---------------------------------------------------------------------------
# source / object resolution
# ---------------------------------------------------------------------------

_FILE_CACHE: Dict[str, Optional[Tuple[ast.Module, List[str]]]] = {}


def _file_ast(path: str):
    """Parsed module AST and source lines of a file, cached; None when the
    source is unavailable (builtins, C extensions, REPL frames)."""
    if path in _FILE_CACHE:
        return _FILE_CACHE[path]
    lines = linecache.getlines(path)
    out = None
    if lines:
        try:
            out = (ast.parse("".join(lines), filename=path), lines)
        except SyntaxError:
            out = None
    _FILE_CACHE[path] = out
    return out


def _unwrap(fn):
    fn = inspect.unwrap(fn)
    if isinstance(fn, functools.partial):
        fn = inspect.unwrap(fn.func)
    if isinstance(fn, types.MethodType):
        fn = fn.__func__
    return fn


def _callable_node(fn) -> Optional[Tuple[ast.AST, str]]:
    """``(function/lambda AST node, file path)`` of a live Python
    function, found by parsing its file and matching the code object's
    first line (robust for lambdas inside larger expressions)."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return None
    path = code.co_filename
    parsed = _file_ast(path)
    if parsed is None:
        return None
    tree, _ = parsed
    name = getattr(fn, "__name__", "<lambda>")
    argnames = list(code.co_varnames[:code.co_argcount])
    fallback = None
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name != name:
                continue
            first = node.decorator_list[0].lineno if node.decorator_list \
                else node.lineno
            if first <= code.co_firstlineno <= node.lineno:
                return node, path
            fallback = fallback or (node, path)
        elif isinstance(node, ast.Lambda) and name == "<lambda>":
            if node.lineno == code.co_firstlineno \
                    and [a.arg for a in node.args.args] == argnames:
                return node, path
    return fallback


class _Env:
    """Name resolution for one function object: closure cells first, then
    ``__globals__``, then builtins."""

    def __init__(self, fn) -> None:
        self.closure: Dict[str, Any] = {}
        code = getattr(fn, "__code__", None)
        cells = getattr(fn, "__closure__", None)
        if code is not None and cells:
            for nm, cell in zip(code.co_freevars, cells):
                try:
                    self.closure[nm] = cell.cell_contents
                except ValueError:      # empty cell (still being built)
                    pass
        self.globals = getattr(fn, "__globals__", {}) or {}
        self.free = set(self.closure)

    def resolve(self, name: str) -> Tuple[bool, Any]:
        if name in self.closure:
            return True, self.closure[name]
        if name in self.globals:
            return True, self.globals[name]
        bi = self.globals.get("__builtins__")
        bi = bi.__dict__ if isinstance(bi, types.ModuleType) else (bi or {})
        if isinstance(bi, dict) and name in bi:
            return True, bi[name]
        return False, None

    def resolve_expr(self, node) -> Tuple[bool, Any]:
        """Resolve a Name / dotted-attribute chain to a live object."""
        if isinstance(node, ast.Name):
            return self.resolve(node.id)
        if isinstance(node, ast.Attribute):
            ok, base = self.resolve_expr(node.value)
            if ok:
                try:
                    return True, getattr(base, node.attr)
                except AttributeError:
                    return False, None
        return False, None


def _root_name(node) -> Optional[str]:
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _attr_chain(node) -> List[str]:
    """``a.b.c`` -> ["a", "b", "c"]; [] when not a pure dotted chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


# ---------------------------------------------------------------------------
# suppression
# ---------------------------------------------------------------------------

def suppression_at(path: str, lineno: int) -> Optional[str]:
    """``"ok"`` when a justified ``# wfverify: ok (reason)`` covers the
    line (same line or the two above), ``"missing-reason"`` when the
    token is present without a parenthesized reason, else None."""
    lines = linecache.getlines(path)
    text = "".join(lines[max(0, lineno - 3):lineno])
    if SUPPRESS_TOKEN not in text:
        return None
    return "ok" if _SUPPRESS_RE.search(text) else "missing-reason"


# ---------------------------------------------------------------------------
# per-function verification
# ---------------------------------------------------------------------------

class _Finding:
    __slots__ = ("code", "message", "path", "lineno", "hint")

    def __init__(self, code, message, path, lineno, hint=None):
        self.code = code
        self.message = message
        self.path = path
        self.lineno = lineno
        self.hint = hint


class _FnCheck:
    """One function's walk.  ``traced``: the function runs in a device
    step a megastep may capture (the host-read and frozen-value families
    apply, its parameters are tensors); ``durable``: the graph
    checkpoints (the determinism family applies)."""

    def __init__(self, fn, node, path, *, traced: bool, durable: bool,
                 depth: int, findings: List[_Finding],
                 visited: Set[Tuple[Any, ...]],
                 taint: Optional[Set[str]] = None) -> None:
        self.fn = fn
        self.node = node
        self.path = path
        self.traced = traced
        self.durable = durable
        self.depth = depth
        self.findings = findings
        self.visited = visited
        self.env = _Env(fn)
        args = node.args
        names = [a.arg for a in (args.posonlyargs + args.args
                                 + args.kwonlyargs)]
        if args.vararg:
            names.append(args.vararg.arg)
        if args.kwarg:
            names.append(args.kwarg.arg)
        self.params = set(names)
        # an entry point's parameters are all tensors (a method's
        # receiver excepted: it is the operator object); a followed
        # callee's only where its caller passed one (``taint``)
        if taint is None:
            taint = {n for n in names if n not in ("self", "cls")}
        self.tainted: Set[str] = set(taint) if traced else set()
        #: params with mutable defaults (shared across calls)
        self.mutable_defaults: Set[str] = set()
        defaults = getattr(fn, "__defaults__", None) or ()
        pos = (args.posonlyargs + args.args)[-len(defaults):] \
            if defaults else []
        for a, d in zip(pos, defaults):
            if isinstance(d, _MUTABLE_CONTAINERS):
                self.mutable_defaults.add(a.arg)
        # every Store-ed name is local unless declared global/nonlocal;
        # mutations of NON-locals are the state the WF803 pass hunts
        self.declared: Set[str] = set()
        self.locals: Set[str] = set(self.params)
        body = node.body if isinstance(node.body, list) else [node.body]
        for n in ast.walk(node):
            if isinstance(n, (ast.Global, ast.Nonlocal)):
                self.declared.update(n.names)
            elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                self.locals.add(n.id)
            elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.locals.add(n.name)
        self.locals -= self.declared
        #: inner ``def``s, followable when called or passed on
        self.local_defs = {
            n.name: n for n in ast.walk(node)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and n is not node}
        #: (lineno, col) of calls the determinism pass claimed, so the
        #: frozen-value pass does not report the same call twice
        self._det_hits: Set[Tuple[int, int]] = set()
        self._body = body

    # -- taint ---------------------------------------------------------------
    def expr_tainted(self, e) -> bool:
        if e is None or isinstance(e, ast.Constant):
            return False
        if isinstance(e, ast.Name):
            return e.id in self.tainted
        if isinstance(e, ast.Attribute):
            if e.attr in _STATIC_ATTRS:
                return False
            return self.expr_tainted(e.value)
        if isinstance(e, ast.Call):
            fname = e.func.id if isinstance(e.func, ast.Name) else None
            if fname in _STATIC_FNS or fname in _HOST_CASTS:
                return False    # metadata, or a host value (the read
                #                 itself is the finding)
            if isinstance(e.func, ast.Attribute) \
                    and (e.func.attr in _STATIC_ATTRS
                         or e.func.attr in _HOST_READS):
                return False    # x.size(), x.numel(); x.item(): host
            if self.expr_tainted(e.func):
                return True
            return any(self.expr_tainted(a) for a in e.args) \
                or any(self.expr_tainted(k.value) for k in e.keywords)
        if isinstance(e, ast.Lambda):
            return False
        for child in ast.iter_child_nodes(e):
            if isinstance(child, ast.expr) and self.expr_tainted(child):
                return True
            if isinstance(child, ast.comprehension) \
                    and self.expr_tainted(child.iter):
                return True
        return False

    def _taint_target(self, tgt, is_tainted: bool) -> None:
        for n in ast.walk(tgt):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                if is_tainted:
                    self.tainted.add(n.id)
                else:
                    self.tainted.discard(n.id)

    # -- findings ------------------------------------------------------------
    def emit(self, code: str, node, message: str,
             hint: Optional[str] = None) -> None:
        self.findings.append(_Finding(
            code, message, self.path, getattr(node, "lineno", 0), hint))

    # -- walk ----------------------------------------------------------------
    def run(self) -> None:
        for stmt in self._body:
            if isinstance(stmt, ast.stmt):
                self._stmt(stmt)
            else:       # lambda body: one bare expression
                self._expr(stmt)

    def _stmt(self, s) -> None:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            return      # inner defs are analyzed when called/passed
        if isinstance(s, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = s.value
            if value is not None:
                self._expr(value)
            tainted = self.expr_tainted(value) if value is not None \
                else False
            targets = s.targets if isinstance(s, ast.Assign) \
                else [s.target]
            for t in targets:
                self._check_store(t, s)
                if isinstance(s, ast.AugAssign):
                    tainted = tainted or self.expr_tainted(t)
                self._taint_target(t, tainted)
            return
        if isinstance(s, (ast.If, ast.While)):
            self._branch_test(s.test)
            self._expr(s.test)
            for b in s.body:
                self._stmt(b)
            for b in s.orelse:
                self._stmt(b)
            return
        if isinstance(s, ast.Assert):
            self._branch_test(s.test)
            self._expr(s.test)
            return
        if isinstance(s, ast.For):
            self._expr(s.iter)
            self._order_dep(s.iter)
            self._taint_target(s.target, self.expr_tainted(s.iter))
            for b in s.body + s.orelse:
                self._stmt(b)
            return
        if isinstance(s, ast.With):
            for item in s.items:
                self._expr(item.context_expr)
            for b in s.body:
                self._stmt(b)
            return
        if isinstance(s, ast.Try):
            for b in (s.body + s.orelse + s.finalbody):
                self._stmt(b)
            for h in s.handlers:
                for b in h.body:
                    self._stmt(b)
            return
        if isinstance(s, ast.Return) and s.value is not None:
            self._expr(s.value)
            return
        if isinstance(s, ast.Expr):
            self._expr(s.value)
            return
        for child in ast.iter_child_nodes(s):
            if isinstance(child, ast.stmt):
                self._stmt(child)
            elif isinstance(child, ast.expr):
                self._expr(child)

    # -- stores (WF803: mutation of non-local state) -------------------------
    def _check_store(self, tgt, stmt) -> None:
        if not self.traced:
            return
        for n in ast.walk(tgt):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store) \
                    and n.id in self.declared:
                self.emit(
                    "WF803", stmt,
                    f"assignment to '{n.id}' (declared global/nonlocal) "
                    "inside a device kernel — a captured replay skips "
                    "it, so it runs at the capture only",
                    hint="thread state through the function's inputs and "
                         "outputs instead")
            elif isinstance(n, ast.Subscript):
                root = _root_name(n.value)
                if root is not None and root not in self.locals \
                        and isinstance(n.ctx, ast.Store):
                    ok, val = self.env.resolve(root)
                    if ok and isinstance(val, _MUTABLE_CONTAINERS):
                        self.emit(
                            "WF803", stmt,
                            f"subscript write to closure/global "
                            f"'{root}' inside a device kernel — a host "
                            "side effect a captured replay skips",
                            hint="return the value instead of mutating "
                                 "enclosing state")

    # -- branch tests (WF802) ------------------------------------------------
    def _branch_test(self, test) -> None:
        if not self.traced:
            return
        bad = self._violating_test(test)
        if bad is not None:
            self.emit(
                "WF802", bad,
                "Python control flow branches on a device tensor — a "
                "host sync every call, and a captured replay keeps the "
                f"branch of the capture ({ast.unparse(bad)[:60]!r})",
                hint="use torch.where, or lift the decision to a host "
                     "value known before the step")

    def _violating_test(self, t):
        if isinstance(t, ast.BoolOp):
            for v in t.values:
                bad = self._violating_test(v)
                if bad is not None:
                    return bad
            return None
        if isinstance(t, ast.UnaryOp) and isinstance(t.op, ast.Not):
            return self._violating_test(t.operand)
        if isinstance(t, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in t.ops):
                return None     # identity/membership: Python-level checks
        if isinstance(t, ast.Call):
            fname = t.func.id if isinstance(t.func, ast.Name) else None
            if fname in _STATIC_FNS:
                return None
        return t if self.expr_tainted(t) else None

    # -- expressions ---------------------------------------------------------
    def _expr(self, e) -> None:
        for node in ast.walk(e):
            if isinstance(node, ast.Call):
                self._call(node)
            elif isinstance(node, ast.Subscript) and self.traced:
                self._subscript(node)
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                for gen in node.generators:
                    self._order_dep(gen.iter)
            elif isinstance(node, ast.IfExp):
                self._branch_test(node.test)

    def _subscript(self, node: ast.Subscript) -> None:
        # boolean-mask indexing: x[mask] with a tensor comparison mask
        # sizes the output by the batch's content (WF812)
        sl = node.slice
        if isinstance(sl, ast.Compare) and self.expr_tainted(sl) \
                and self.expr_tainted(node.value):
            self.emit(
                "WF812", node,
                "boolean-mask indexing of a device tensor "
                f"({ast.unparse(node)[:60]!r}) — the output shape "
                "depends on batch content: a host sync, and no CUDA "
                "graph captures it",
                hint="keep a fixed shape: torch.where(mask, x, fill) or a "
                     "validity lane")

    # -- calls: the heart of every family ------------------------------------
    def _call(self, node: ast.Call) -> None:
        func = node.func
        fname = func.id if isinstance(func, ast.Name) else None
        attr = func.attr if isinstance(func, ast.Attribute) else None
        chain = _attr_chain(func) if isinstance(func, ast.Attribute) else []
        resolved, obj = self.env.resolve_expr(func) \
            if isinstance(func, (ast.Name, ast.Attribute)) else (False, None)

        if self.durable:
            self._determinism_call(node, fname, attr, chain, resolved, obj)
        if self.traced:
            self._trace_safety_call(node, fname, attr, chain)
            self._recompile_call(node, fname, attr, chain, resolved, obj)
        self._maybe_follow(node, fname, resolved, obj)

    # .. host reads (WF80x) ..................................................
    def _trace_safety_call(self, node, fname, attr, chain) -> None:
        args_tainted = any(self.expr_tainted(a) for a in node.args)
        if fname in _HOST_CASTS and args_tainted:
            self.emit(
                "WF801", node,
                f"{fname}() reads a device tensor on the host — a sync "
                "every call, and a captured replay keeps the value of "
                "the capture",
                hint="stay on the card (.to(dtype), torch.where), or "
                     "pass the value in as a host argument")
            return
        if attr in _HOST_READS and self.expr_tainted(node.func.value):
            self.emit(
                "WF801", node,
                f".{attr}() pulls a device tensor to the host inside a "
                "device kernel",
                hint="keep the value on the card; read it outside the "
                     "step")
            return
        if attr in ("asarray", "array") and chain and args_tainted:
            root = chain[0]
            ok, mod = self.env.resolve(root)
            is_np = (ok and getattr(mod, "__name__", "") == "numpy") \
                or (not ok and root in ("np", "numpy"))
            if is_np:
                self.emit(
                    "WF801", node,
                    f"{root}.{attr}() copies a device tensor to a host "
                    "numpy array inside a device kernel",
                    hint="use torch ops on the card")
                return
        if fname == "print":
            self.emit(
                "WF804", node,
                "print() inside a device kernel runs at the capture "
                "only; a captured replay prints nothing",
                hint="log from the host side of the step")

    # .. frozen values and dynamic shapes (WF81x) ............................
    def _recompile_call(self, node, fname, attr, chain, resolved,
                        obj) -> None:
        key = (node.lineno, node.col_offset)
        if key in self._det_hits:
            return      # the determinism pass already owns this call
        if fname == "len" and node.args:
            arg = node.args[0]
            if isinstance(arg, (ast.Name, ast.Attribute)):
                ok, val = self.env.resolve_expr(arg)
                root = _root_name(arg)
                if ok and isinstance(val, _MUTABLE_CONTAINERS) \
                        and root not in self.locals:
                    self.emit(
                        "WF811", node,
                        f"len({ast.unparse(arg)}) of a mutable "
                        f"closure/global {type(val).__name__} is read "
                        "at the capture — a captured replay keeps the "
                        "old value when the container grows",
                        hint="freeze the container (tuple) or pass the "
                             "length in as a host argument")
            return
        if fname == "next" and not self._local_iterator(node):
            self.emit(
                "WF811", node,
                "next() advances host state each call — a captured "
                "replay freezes the value of the capture",
                hint="thread the value in as an argument")
            return
        if not self.durable:
            # the determinism pass owns wall clocks under durability
            wall = self._wallclock_target(node, chain, resolved, obj)
            if wall:
                self.emit(
                    "WF811", node,
                    f"{wall} runs on the host inside a device kernel — a "
                    "captured replay freezes the value of the capture",
                    hint="compute it on the host and pass it as an "
                         "operand")
        recv_tainted = isinstance(node.func, ast.Attribute) \
            and self.expr_tainted(node.func.value)
        args_tainted = any(self.expr_tainted(a) for a in node.args)
        torch_call = bool(chain) and chain[0] in _TORCH_ROOTS
        if attr in _SHAPE_DYNAMIC:
            if (torch_call and args_tainted) or recv_tainted:
                self.emit(
                    "WF812", node,
                    f"{attr}() has a data-dependent output shape — a "
                    "host sync, and no CUDA graph captures it",
                    hint="use a masked fixed-shape formulation (a "
                         "validity lane, torch.where)")
            return
        if attr == "repeat_interleave" \
                and (recv_tainted or (torch_call and args_tainted)) \
                and not any(k.arg == "output_size" for k in node.keywords):
            self.emit(
                "WF812", node,
                "repeat_interleave() without output_size sizes its "
                "output from the counts — a host sync, and no CUDA "
                "graph captures it",
                hint="pass output_size= (a host-known bound)")
            return
        if attr == "where" and torch_call and len(node.args) == 1 \
                and self.expr_tainted(node.args[0]):
            self.emit(
                "WF812", node,
                "one-argument where() returns data-dependent-shape "
                "indices — a host sync, and no CUDA graph captures it",
                hint="use the three-argument torch.where(cond, x, y)")

    def _local_iterator(self, node) -> bool:
        """``next(it)`` over an iterator the body made itself: advances
        nothing that outlives the call."""
        arg = node.args[0] if node.args else None
        return isinstance(arg, ast.Name) and arg.id in self.locals \
            and arg.id not in self.params

    def _wallclock_target(self, node, chain, resolved,
                          obj) -> Optional[str]:
        """Dotted name of a wall-clock read, or None: object-level first
        (the closure may alias ``import time as t``), names second."""
        if resolved and isinstance(obj, types.BuiltinFunctionType) \
                and getattr(obj, "__module__", "") == "time" \
                and obj.__name__ in _WALLCLOCK_TIME_ATTRS:
            return f"time.{obj.__name__}"
        if resolved and getattr(obj, "__name__", "") \
                in _WALLCLOCK_DT_ATTRS \
                and "datetime" in getattr(obj, "__qualname__", ""):
            return f"datetime.{obj.__name__}"
        if resolved and getattr(obj, "__name__", "") \
                == "current_time_usecs":
            return "current_time_usecs"
        if len(chain) >= 2:
            if chain[-2] == "time" and chain[-1] in _WALLCLOCK_TIME_ATTRS:
                return ".".join(chain)
            if chain[-2] in ("datetime", "date") \
                    and chain[-1] in _WALLCLOCK_DT_ATTRS:
                return ".".join(chain)
        return None

    # .. determinism (WF61x) .................................................
    def _determinism_call(self, node, fname, attr, chain, resolved,
                          obj) -> None:
        key = (node.lineno, node.col_offset)
        wall = self._wallclock_target(node, chain, resolved, obj)
        if wall:
            self._det_hits.add(key)
            self.emit(
                "WF612", node,
                f"{wall} read in a kernel/callback of a checkpointed "
                "graph — a replay re-reads a DIFFERENT clock, so the "
                "exactly-once fence dedupes records that no longer "
                "match",
                hint="derive times from the record's event timestamp "
                     "lane, never the host clock")
            return
        if fname == "id":
            self._det_hits.add(key)
            self.emit(
                "WF613", node,
                "id() is a process-lifetime address — differs on every "
                "replay of a checkpointed graph", hint=None)
            return
        if fname == "hash":
            self._det_hits.add(key)
            self.emit(
                "WF613", node,
                "hash() of str/bytes is salted per process "
                "(PYTHONHASHSEED) — a restored run computes different "
                "hashes than the checkpointed one",
                hint="use a content hash (hashlib) or an integer key")
            return
        rng = self._rng_target(node, chain, resolved, obj)
        if rng:
            self._det_hits.add(key)
            self.emit(
                "WF611", node,
                f"{rng} draws from hidden RNG state in a "
                "kernel/callback of a checkpointed graph — replays "
                "diverge from the committed prefix",
                hint="pass a torch.Generator seeded from the record or "
                     "batch index (generator=), or a seeded numpy "
                     "Generator captured in the checkpoint")

    def _rng_target(self, node, chain, resolved, obj) -> Optional[str]:
        # torch's global generator: a draw without generator=
        name = chain[-1] if chain else None
        if name in _TORCH_RNG and chain[0] in _TORCH_ROOTS \
                and not any(k.arg == "generator" for k in node.keywords):
            return ".".join(chain) + " without generator="
        mod = (getattr(obj, "__module__", "") or "") if resolved else ""
        recv = getattr(obj, "__self__", None) if resolved else None
        if recv is not None:
            # bound methods of the stdlib/numpy module-level RNGs
            # (random.random is a method of the module's Random object)
            rt = type(recv)
            rmod = getattr(rt, "__module__", "") or ""
            if rmod == "random" or rmod.startswith("numpy.random"):
                return f"{rmod}.{rt.__name__}." \
                       f"{getattr(obj, '__name__', '?')}"
        if resolved and (mod == "random" or mod.startswith("numpy.random")):
            return f"{mod}.{getattr(obj, '__name__', name or '?')}"
        if not resolved and len(chain) >= 2 and "random" in chain[:-1] \
                and chain[0] not in _TORCH_ROOTS:
            return ".".join(chain)
        if isinstance(node.func, ast.Attribute):
            ok_recv, recv = self.env.resolve_expr(node.func.value)
            tn = type(recv).__name__ if ok_recv else ""
            if tn in ("Generator", "RandomState") and ok_recv \
                    and type(recv).__module__.startswith("numpy.random"):
                return f"numpy.random.{tn}.{node.func.attr}"
        return None

    # .. iteration order (WF614) .............................................
    def _order_dep(self, it) -> None:
        if not self.durable:
            return
        src = self._setish(it)
        if src is not None:
            self.emit(
                "WF614", it,
                f"iteration over a set ({src}) in a kernel/callback of "
                "a checkpointed graph — set order is salted per process "
                "(PYTHONHASHSEED), so a restored run emits a different "
                "order than the checkpointed one",
                hint="iterate sorted(...) or use a list/dict (insertion "
                     "order is deterministic)")

    def _setish(self, e) -> Optional[str]:
        if isinstance(e, (ast.Set, ast.SetComp)):
            return "set literal"
        if isinstance(e, ast.Call):
            fname = e.func.id if isinstance(e.func, ast.Name) else None
            if fname in ("set", "frozenset"):
                return f"{fname}(...)"
            if fname in ("vars", "globals", "locals"):
                return f"{fname}()"
            if fname in ("list", "tuple", "enumerate", "reversed") \
                    and e.args:
                # these PRESERVE the inner order: look through them
                return self._setish(e.args[0])
        if isinstance(e, (ast.Name, ast.Attribute)):
            ok, val = self.env.resolve_expr(e)
            if ok and isinstance(val, (set, frozenset)):
                return f"'{ast.unparse(e)}' (a {type(val).__name__})"
        return None

    # .. mutation via method calls (WF803) + interprocedural follow ..........
    def _maybe_follow(self, node: ast.Call, fname, resolved, obj) -> None:
        func = node.func
        if self.traced and isinstance(func, ast.Attribute) \
                and func.attr in _MUTATORS:
            root = _root_name(func.value)
            if root is not None and root not in self.locals \
                    and root not in self.params:
                ok, val = self.env.resolve(root)
                if (ok and isinstance(val, _MUTABLE_CONTAINERS)) \
                        or (not ok and root in self.env.free):
                    self.emit(
                        "WF803", node,
                        f"'{root}.{func.attr}()' mutates closure/global "
                        "state inside a device kernel — a captured "
                        "replay skips it, so it runs at the capture only",
                        hint="return the data instead of accumulating "
                             "into enclosing state")
            elif root in self.mutable_defaults:
                self.emit(
                    "WF803", node,
                    f"'{root}.{func.attr}()' mutates a mutable default "
                    "argument inside a device kernel — state shared "
                    "across calls, written at the capture only",
                    hint="default to None and construct per call")
        if self.depth <= 0:
            return
        call_args = node.args
        if resolved and inspect.isfunction(_unwrap(obj)):
            callee = _unwrap(obj)
            if _followable(callee):
                taint = self._arg_taint(callee, node,
                                        isinstance(obj, types.MethodType))
                _verify_into(callee, traced=self.traced and bool(taint),
                             durable=self.durable, depth=self.depth - 1,
                             findings=self.findings, visited=self.visited,
                             taint=taint)
        elif fname in self.local_defs:
            self._follow_local(self.local_defs[fname])
            return
        # functions passed as arguments (per_record(fn, ...), a
        # higher-order helper): the argument is what runs
        for a in call_args:
            if isinstance(a, ast.Name) and a.id in self.local_defs:
                self._follow_local(self.local_defs[a.id])
            elif isinstance(a, (ast.Name, ast.Attribute)):
                ok, f = self.env.resolve_expr(a)
                if ok and inspect.isfunction(_unwrap(f)) \
                        and _followable(_unwrap(f)):
                    _verify_into(_unwrap(f), traced=self.traced,
                                 durable=self.durable, depth=self.depth - 1,
                                 findings=self.findings,
                                 visited=self.visited)

    def _arg_taint(self, callee, node: ast.Call, bound: bool) -> Set[str]:
        """The callee's parameters that receive a tensor at this call:
        positional arguments by position (a bound method's receiver
        skipped), keywords by name; a tensor in ``*args``/``**kwargs``
        taints every parameter it may reach."""
        code = callee.__code__
        names = list(code.co_varnames[:code.co_argcount
                                      + code.co_kwonlyargcount])
        pos = names[:code.co_argcount][1 if bound else 0:]
        taint: Set[str] = set()
        for i, a in enumerate(node.args):
            if not self.expr_tainted(a):
                continue
            if isinstance(a, ast.Starred) or i >= len(pos):
                taint.update(names)
                if code.co_flags & inspect.CO_VARARGS:
                    taint.add(code.co_varnames[len(names)])
            else:
                taint.add(pos[i])
        for k in node.keywords:
            if self.expr_tainted(k.value):
                if k.arg is None:
                    taint.update(names)
                else:
                    taint.add(k.arg)
        return taint

    def _follow_local(self, defnode) -> None:
        """Analyze an inner ``def`` with this function's environment
        (approximation: inner defs close over our scope)."""
        key = (defnode, self.traced, self.durable)
        if key in self.visited:
            return
        self.visited.add(key)
        _FnCheck(self.fn, defnode, self.path, traced=self.traced,
                 durable=self.durable, depth=self.depth - 1,
                 findings=self.findings, visited=self.visited).run()


def _followable(fn) -> bool:
    """Follow user and package functions; torch, numpy and the stdlib are
    opaque (their internals are not the user's kernel code)."""
    mod = getattr(fn, "__module__", "") or ""
    if mod.startswith(("torch", "numpy", "scipy", "jax", "builtins",
                       "functools", "itertools", "threading", "json",
                       "math")):
        return False
    return getattr(fn, "__code__", None) is not None


def _verify_into(fn, *, traced: bool, durable: bool, depth: int,
                 findings: List[_Finding], visited: Set,
                 taint: Optional[Set[str]] = None) -> None:
    """Walk one function; ``taint`` names its tensor parameters (None:
    all of them, the entry-point view)."""
    fn = _unwrap(fn)
    code = getattr(fn, "__code__", None)
    if code is None:
        return
    key = (code, traced, durable,
           None if taint is None else frozenset(taint))
    if key in visited:
        return
    visited.add(key)
    located = _callable_node(fn)
    if located is None:
        return
    node, path = located
    _FnCheck(fn, node, path, traced=traced, durable=durable, depth=depth,
             findings=findings, visited=visited, taint=taint).run()


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

_KERNEL_CACHE: Dict[Tuple[Any, bool, bool], List[_Finding]] = {}


def verify_callable(fn, *, traced: bool, durable: bool = False,
                    depth: int = MAX_CALL_DEPTH) -> List[_Finding]:
    """Raw findings (before suppression) of one function object, cached
    by code object.  A function WITH closure cells is never cached: its
    findings depend on the cell values, and one code object is shared by
    every closure made from it."""
    fn = _unwrap(fn)
    code = getattr(fn, "__code__", None)
    if code is None:
        return []
    cacheable = not getattr(fn, "__closure__", None)
    key = (code, traced, durable)
    if cacheable:
        hit = _KERNEL_CACHE.get(key)
        if hit is not None:
            return hit
    findings: List[_Finding] = []
    _verify_into(fn, traced=traced, durable=durable, depth=depth,
                 findings=findings, visited=set())
    if cacheable:
        _KERNEL_CACHE[key] = findings
    return findings


class VerifyReport:
    """Outcome of :func:`verify_graph`: reportable diagnostics, findings
    suppressed inline (with their reason), the wall cost, and the
    donation family's verdict (not applicable to the port)."""

    def __init__(self) -> None:
        self.diagnostics: List[Diagnostic] = []
        self.suppressed: List[Diagnostic] = []
        self.checked = 0
        self.check_ms = 0.0
        self.donation = DONATION_NOTE

    def to_json(self) -> dict:
        return {
            "checked_callables": self.checked,
            "check_ms": self.check_ms,
            "findings": len(self.diagnostics),
            "suppressed": len(self.suppressed),
            "diagnostics": [d.to_json() for d in self.diagnostics],
            "suppressed_diagnostics": [d.to_json()
                                       for d in self.suppressed],
            "donation": self.donation,
        }


def _graph_callables(graph):
    """Yield ``(fn, op_name, role, traced)`` for every user callable the
    runtime invokes: a device operator's functions (traced: a megastep
    may capture them) and host callbacks (the determinism surface)."""
    from windflow_tpu_torch.ops.chained import ChainedGPU, ChainedHost
    seen: Set[int] = set()

    def one(fn, name, role, traced):
        if fn is None or not callable(fn) or id(fn) in seen:
            return None
        seen.add(id(fn))
        return (fn, name, role, traced)

    for op in graph._topo_operators():
        gpu = getattr(op, "is_gpu", False)
        if isinstance(op, ChainedGPU):
            for st in op.stages:
                got = one(st.fn, op.name, f"{type(st).__name__} stage",
                          True)
                if got:
                    yield got
        elif isinstance(op, ChainedHost):
            for kind, fn in op.specs:
                got = one(fn, op.name, f"{kind} stage", False)
                if got:
                    yield got
        for attr, role in (("fn", "kernel"), ("comb", "combiner"),
                           ("lift", "window lift"),
                           ("batch_fn", "batch generator"),
                           ("ts_fn", "timestamp kernel"),
                           ("gen_fn", "generator"),
                           ("deser_fn", "deserializer"),
                           ("ser_fn", "serializer"),
                           ("wm_fn", "watermark fn"),
                           ("ts_extractor", "timestamp extractor"),
                           ("closing_func", "closing callback")):
            fn = getattr(op, attr, None)
            traced = gpu and attr in ("fn", "comb", "lift", "batch_fn",
                                      "ts_fn")
            got = one(fn, op.name, role, traced)
            if got:
                yield got
        for fn, role in zip(getattr(op, "assoc", None) or (),
                            ("associative lift", "associative combiner",
                             "associative projection")):
            got = one(fn, op.name, role, gpu)
            if got:
                yield got
        got = one(getattr(op, "key_extractor", None), op.name,
                  "key extractor", gpu)
        if got:
            yield got


def _framework_traced_bodies(graph):
    """The port's own step bodies reachable from the graph's operators
    now: a chain's record transform (``ChainedGPU``'s prelude) at any
    time, and once the graph has stepped, every step function the
    operators cached (the reduce routes, the window step, the stateful
    bodies, a fused segment's prelude and executor) — what a megastep
    captures."""
    out = []
    seen: Set[int] = set()

    def add(fn, name):
        if callable(fn) and id(fn) not in seen:
            seen.add(id(fn))
            out.append((fn, name))

    for op in graph._topo_operators():
        chain = getattr(op, "_chain", None)
        if chain is not None:
            add(getattr(chain, "_prelude", None), op.name)
        for cache in ("_steps", "_bodies"):
            for fn in (getattr(op, cache, None) or {}).values():
                add(fn, op.name)
        add(getattr(op, "_step_fn", None), op.name)
        add(getattr(op, "_fused_prelude", None), op.name)
        fx = getattr(op, "_fusion_exec", None)
        if fx is not None:
            add(getattr(fx, "_prelude", None), op.name)
    return out


_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _apply_suppressions(findings: List[_Finding], op_name: Optional[str],
                        report: VerifyReport,
                        seen: Optional[Set[Tuple]] = None) -> None:
    for f in findings:
        if seen is not None:
            key = (f.code, f.path, f.lineno)
            if key in seen:
                continue    # one report per site
            seen.add(key)
        sup = suppression_at(f.path, f.lineno)
        path = f.path
        if path.startswith(_REPO + os.sep):
            path = os.path.relpath(path, _REPO)
        d = Diagnostic(f.code, f.message, node=op_name,
                       location=f"{path}:{f.lineno}", hint=f.hint)
        if sup == "ok":
            report.suppressed.append(d)
        elif sup == "missing-reason":
            d.message += (" [a 'wfverify: ok' suppression without a "
                          "(reason) was ignored — justify it]")
            report.diagnostics.append(d)
        else:
            report.diagnostics.append(d)


def verify_graph(graph) -> VerifyReport:
    """Run the wfverify families over a composed PipeGraph's live
    callables.  The determinism family (WF61x) activates when the graph
    checkpoints; the host-read and frozen-value families apply to device
    operators' functions and the port's step bodies.
    ``PipeGraph.check()`` folds the diagnostics into the preflight list
    (severity policy follows ``Config.preflight``)."""
    t0 = time.perf_counter()
    report = VerifyReport()
    seen: Set[Tuple] = set()
    durable = bool(getattr(graph.config, "durability", ""))
    for fn, op_name, _role, traced in _graph_callables(graph):
        findings = verify_callable(fn, traced=traced, durable=durable)
        report.checked += 1
        _apply_suppressions(findings, op_name, report, seen)
    for fn, op_name in _framework_traced_bodies(graph):
        findings = verify_callable(fn, traced=True, durable=durable,
                                   depth=FRAMEWORK_DEPTH)
        report.checked += 1
        _apply_suppressions(findings, op_name, report, seen)
    report.check_ms = round((time.perf_counter() - t0) * 1e3, 3)
    return report
