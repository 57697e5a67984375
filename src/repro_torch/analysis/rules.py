"""The codified invariants (RPR001–RPR008), read for the port
(counterpart of `repro/analysis/rules.py`).

Each rule's docstring states the contract and the motivating incident —
where the reference established the convention by hand (see
docs/INVARIANTS.md for the full catalogue).  Rules are AST pattern
checks, deliberately narrow: they pin the exact idiom the incident
taught us to require, and anything cleverer than the idiom carries a
``# repro: noqa RPRxxx -- reason`` at the point of use.

The ids, titles, module globs, exemptions and contracts are the
reference's.  Two rules name the accelerator stack, and the port reads
them for its own: RPR001's heavy set is ``torch``, and RPR004 also flags
draws from torch's default generator (its "Port reading" paragraphs).
The other six check the same patterns the reference checks, so on any
tree both linters report them identically.

Static analysis approximates dynamic properties.  Where a rule says "on
every exit path" the check is structural (a ``finally`` join or a
registered closer method), not a full CFG walk — the approximation is
documented per rule and the fixture tests in tests/test_torch_analysis.py
pin both the firing and the compliant idiom.
"""
from __future__ import annotations

import ast
from fnmatch import fnmatch
from typing import Iterator

Finding = "tuple[int, int, str]"  # (line, col, message)


# ------------------------------------------------------------------ helpers


def _dotted(node: ast.AST) -> "str | None":
    """`a.b.c` as text for Name/Attribute chains, else None."""
    parts: list[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def _alias_map(tree: ast.Module) -> dict[str, str]:
    """Local alias -> qualified name, from every import in the module."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _qualify(node: ast.AST, aliases: dict[str, str]) -> "str | None":
    """Resolve a Name/Attribute chain through the module's import aliases."""
    dotted = _dotted(node)
    if dotted is None:
        return None
    head, _, rest = dotted.partition(".")
    head = aliases.get(head, head)
    return f"{head}.{rest}" if rest else head


def _call_mode(call: ast.Call) -> "str | None":
    """The literal mode of an `open()` call ('r' if omitted, None if dynamic)."""
    mode_node: "ast.AST | None" = None
    if len(call.args) >= 2:
        mode_node = call.args[1]
    else:
        for kw in call.keywords:
            if kw.arg == "mode":
                mode_node = kw.value
    if mode_node is None:
        return "r"
    if isinstance(mode_node, ast.Constant) and isinstance(mode_node.value, str):
        return mode_node.value
    return None


def _module_level(stmts) -> Iterator[ast.stmt]:
    """Statements executed at import time: module body, recursing into
    top-level If/Try/With but never into function or class bodies.
    ``if TYPE_CHECKING:`` blocks are skipped (not executed at runtime)."""
    for s in stmts:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        if isinstance(s, ast.If):
            if "TYPE_CHECKING" not in ast.dump(s.test):
                yield from _module_level(s.body)
            yield from _module_level(s.orelse)
        elif isinstance(s, ast.Try):
            for blk in (s.body, s.orelse, s.finalbody):
                yield from _module_level(blk)
            for h in s.handlers:
                yield from _module_level(h.body)
        elif isinstance(s, (ast.With, ast.AsyncWith)):
            yield s
            yield from _module_level(s.body)
        else:
            yield s


_FUNC = (ast.FunctionDef, ast.AsyncFunctionDef)


# --------------------------------------------------------------------- base


class Rule:
    """Base: subclass, set `id`/`title`/`modules`, implement `check`."""

    id: str = ""
    title: str = ""
    #: fnmatch globs (package-relative posix paths) the rule applies to
    modules: "tuple[str, ...]" = ("*",)
    #: globs the rule never applies to, checked first
    exempt: "tuple[str, ...]" = ()

    def applies(self, mi) -> bool:
        rel = mi.relpath
        if any(fnmatch(rel, g) for g in self.exempt):
            return False
        return any(fnmatch(rel, g) for g in self.modules)

    def check(self, mi) -> Iterator[tuple[int, int, str]]:
        raise NotImplementedError


class NoEagerHeavyImports(Rule):
    """RPR001 — no eager accelerator imports outside kernels/models/train/configs.

    Contract (the reference's): `jax` costs seconds of import time and is
    fork-hostile; the partitioning path (core/, graphs/,
    distributed/shard_driver, serve/, api/, launch entry points) must
    import it lazily — inside the function or engine branch that needs it
    — so CPU/out-of-core runs and forked shard workers never pay or
    inherit the accelerator stack.

    Incident (the reference's): `distributed/` was made PEP-562-lazy
    because forked shard workers crashed under an inherited XLA runtime;
    launch/serve.py's LM/DLRM imports were made lazy so `--arch partition`
    serving never pays them.  Both were hand fixes to a convention nothing
    enforced.  Whole-module jax engines (e.g. core/multilevel_jax.py)
    carry a per-line noqa — they are the lazy target, not the caller.

    Port reading: the heavy set is `torch`, which costs the port ~2 s of
    import and whose CUDA context and CPU thread pool do not survive
    fork.  The partitioning path imports it inside the engine branch or
    the once-a-run function that launches on a card; whole-module torch
    code (core/multilevel_torch.py, the mesh and step modules) carries a
    per-line noqa and is reached only lazily.
    """

    id = "RPR001"
    title = "no-eager-heavy-imports"
    exempt = ("kernels/*", "models/*", "train/*", "configs/*")
    HEAVY = ("torch",)

    def _is_heavy(self, name: "str | None") -> bool:
        return name is not None and any(
            name == h or name.startswith(h + ".") for h in self.HEAVY
        )

    def check(self, mi):
        for stmt in _module_level(mi.tree.body):
            if isinstance(stmt, ast.Import):
                for a in stmt.names:
                    if self._is_heavy(a.name):
                        yield (
                            stmt.lineno, stmt.col_offset,
                            f"eager top-level import of {a.name!r}: modules outside "
                            "kernels/, models/, train/, configs/ must import torch "
                            "lazily (inside the function or engine branch that "
                            "needs it)",
                        )
                        break
            elif isinstance(stmt, ast.ImportFrom):
                if self._is_heavy(stmt.module):
                    yield (
                        stmt.lineno, stmt.col_offset,
                        f"eager top-level import from {stmt.module!r}: modules "
                        "outside kernels/, models/, train/, configs/ must import "
                        "torch lazily",
                    )


class ThreadLifecycle(Rule):
    """RPR002 — threads join on every exit path; queues are bounded.

    Contract: every `threading.Thread` created in src/ is `.join()`-ed on
    all exit paths — via a `try/finally` join in the creating function, or
    by registering the thread on `self` and joining it in a closer method
    (`close`/`_shutdown`/`_join_all`).  Every `queue.Queue()` passes
    `maxsize`: an unbounded queue turns a slow consumer into unbounded
    memory growth instead of back-pressure.

    Incident (the reference's): pipeline shutdown was hardened after
    worker threads outlived parse errors (leaked threads made
    `active_count` assertions flaky and kept file handles open); the
    prefetch pump and the serve worker repeated the discipline.  `daemon=True` is allowed only
    as a backstop — it never substitutes for the join.

    Approximation: the "all exit paths" check is structural — a join on
    the thread's binding inside a `finally`, or (for `self.<attr>` /
    `self.<list>.append` registrations) a method in the same class that
    reads the attribute and calls `.join`.  A thread that escapes any
    other way needs a per-line noqa with its lifecycle story.
    """

    id = "RPR002"
    title = "thread-lifecycle"

    _QUEUES = ("queue.Queue", "queue.LifoQueue", "queue.PriorityQueue")

    def check(self, mi):
        aliases = _alias_map(mi.tree)
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.Call):
                continue
            qual = _qualify(node.func, aliases)
            if qual in self._QUEUES:
                has_maxsize = bool(node.args) or any(
                    kw.arg == "maxsize" for kw in node.keywords
                )
                if not has_maxsize:
                    # the reference's message, byte for byte: both linters'
                    # reports compare equal
                    yield (
                        node.lineno, node.col_offset,
                        f"{qual}() without maxsize: unbounded queues replace "
                        "back-pressure with unbounded memory growth — pass "
                        "maxsize (PR 6/7 shutdown discipline)",
                    )
            elif qual == "threading.Thread":
                if not self._thread_is_joined(mi, node):
                    yield (
                        node.lineno, node.col_offset,
                        "thread is not provably joined on every exit path: "
                        "join it in a try/finally here, or register it on "
                        "self and join in a closer method (daemon=True is a "
                        "backstop, not a lifecycle)",
                    )

    # ---------------------------------------------------- join detection
    def _thread_is_joined(self, mi, call: ast.Call) -> bool:
        fn = mi.enclosing(call, *_FUNC)
        if fn is None:
            return False  # module-level thread: always flagged
        names, attrs = self._bindings(call)
        if names:
            # one-step escape propagation: self.X = t / self.xs.append(t)
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    attrs.update(self._tuple_attr_bindings(node, names))
                elif isinstance(node, ast.Call):
                    f = node.func
                    if (
                        isinstance(f, ast.Attribute)
                        and f.attr == "append"
                        and node.args
                        and isinstance(node.args[0], ast.Name)
                        and node.args[0].id in names
                        and isinstance(f.value, ast.Attribute)
                    ):
                        attrs.add(f.value.attr)
        if names and self._joined_in_finally(fn, names):
            return True
        if attrs:
            cls = mi.enclosing(call, ast.ClassDef)
            if cls is not None and self._class_has_closer(cls, attrs):
                return True
        return False

    @staticmethod
    def _bindings(call: ast.Call) -> "tuple[set[str], set[str]]":
        names: set[str] = set()
        attrs: set[str] = set()
        parent = getattr(call, "parent", None)
        if isinstance(parent, ast.Assign):
            targets = parent.targets
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                elif isinstance(t, ast.Attribute):
                    attrs.add(t.attr)
                elif isinstance(t, ast.Tuple) and isinstance(parent.value, ast.Tuple):
                    for elt, val in zip(t.elts, parent.value.elts):
                        if val is call:
                            if isinstance(elt, ast.Name):
                                names.add(elt.id)
                            elif isinstance(elt, ast.Attribute):
                                attrs.add(elt.attr)
        return names, attrs

    @staticmethod
    def _tuple_attr_bindings(assign: ast.Assign, names: "set[str]") -> "set[str]":
        """attrs receiving one of `names` via `self.a = t` / `self.a, self.b = q, t`."""
        out: set[str] = set()
        for t in assign.targets:
            if (
                isinstance(t, ast.Attribute)
                and isinstance(assign.value, ast.Name)
                and assign.value.id in names
            ):
                out.add(t.attr)
            elif isinstance(t, ast.Tuple) and isinstance(assign.value, ast.Tuple):
                for elt, val in zip(t.elts, assign.value.elts):
                    if (
                        isinstance(elt, ast.Attribute)
                        and isinstance(val, ast.Name)
                        and val.id in names
                    ):
                        out.add(elt.attr)
        return out

    @staticmethod
    def _joined_in_finally(fn, names: "set[str]") -> bool:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Try):
                continue
            for stmt in node.finalbody:
                for sub in ast.walk(stmt):
                    if (
                        isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "join"
                        and isinstance(sub.func.value, ast.Name)
                        and sub.func.value.id in names
                    ):
                        return True
        return False

    @staticmethod
    def _class_has_closer(cls: ast.ClassDef, attrs: "set[str]") -> bool:
        """Some method both reads one of `attrs` and calls `.join(...)`."""
        for item in cls.body:
            if not isinstance(item, _FUNC):
                continue
            reads_attr = any(
                isinstance(n, ast.Attribute) and n.attr in attrs
                for n in ast.walk(item)
            )
            joins = any(
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "join"
                for n in ast.walk(item)
            )
            if reads_attr and joins:
                return True
        return False


class DeterministicReduction(Rule):
    """RPR003 — label-affecting reductions use the canonical f64 order.

    Contract: any sum that can reach `FennelParams`, block loads, or cut
    state goes through the canonical reductions (graphs/stream.py
    `seq_sum64` / `canonical_totals`, or an explicit
    `.astype(np.float64)` before the reduce).  Dtype-preserving
    `arr.sum()` on float32 arrays accumulates in float32 and diverges
    between stream backends; builtin `sum()` feeding totals does scalar
    f32 chains.  Loops that *mutate* labels/loads/cut state never iterate
    a `set` — set order is not deterministic across processes (string
    hash randomization), so the mutation order must come from `sorted()`
    or an array.

    Incident (the reference's): restream built `FennelParams` from
    `float(node_w.sum())` / `total_edge_weight()` instead of the canonical
    stream totals, so restreamed labels silently diverged between memory
    and disk backends until the conformance suite caught it.
    """

    id = "RPR003"
    title = "deterministic-reduction"
    modules = (
        "core/*.py",
        "serve/service.py",
        "distributed/shard_driver.py",
        "graphs/csr.py",
        "graphs/stream.py",
        "graphs/stream_io.py",
        "graphs/orderings.py",
    )

    _TOTAL_KEYWORDS = ("n_total", "m_total")

    def check(self, mi):
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Call):
                yield from self._check_float_sum(mi, node)
                yield from self._check_builtin_sum(mi, node)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                yield from self._check_set_iteration(mi, node)

    def _check_float_sum(self, mi, call: ast.Call):
        if not (
            isinstance(call.func, ast.Name)
            and call.func.id == "float"
            and len(call.args) == 1
        ):
            return
        for sub in ast.walk(call.args[0]):
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "sum"
                and "float64" not in mi.expr_text(sub)
            ):
                # the reference's message, byte for byte (as every message here)
                yield (
                    call.lineno, call.col_offset,
                    "naive float(...sum()) without an f64 cast: label-affecting "
                    "totals must use seq_sum64/canonical_totals "
                    "(graphs/stream.py) or .astype(np.float64) first — the "
                    "PR 5 FennelParams divergence",
                )
                return

    def _check_builtin_sum(self, mi, call: ast.Call):
        if not (isinstance(call.func, ast.Name) and call.func.id == "sum"):
            return
        parent = getattr(call, "parent", None)
        feeds_total = False
        if (
            isinstance(parent, ast.Call)
            and isinstance(parent.func, ast.Name)
            and parent.func.id == "float"
        ):
            feeds_total = True
        elif isinstance(parent, ast.keyword) and parent.arg in self._TOTAL_KEYWORDS:
            feeds_total = True
        else:
            assign = mi.enclosing(call, ast.Assign)
            if assign is not None and any(
                isinstance(t, (ast.Name, ast.Attribute))
                and ("total" in (getattr(t, "id", "") or getattr(t, "attr", "")).lower()
                     or "load" in (getattr(t, "id", "") or getattr(t, "attr", "")).lower())
                for t in assign.targets
            ):
                # only when the sum is (part of) the assigned value
                feeds_total = True
        if feeds_total:
            yield (
                call.lineno, call.col_offset,
                "builtin sum() feeding a total/load: scalar float chains "
                "bypass the canonical f64 reduction — use "
                "seq_sum64/canonical_totals (graphs/stream.py)",
            )

    @staticmethod
    def _check_set_iteration(mi, loop):
        it = loop.iter
        is_set = isinstance(it, (ast.Set, ast.SetComp)) or (
            isinstance(it, ast.Call)
            and isinstance(it.func, ast.Name)
            and it.func.id in ("set", "frozenset")
        )
        if not is_set:
            return
        mutates = any(
            (isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Subscript) for t in n.targets))
            or (isinstance(n, ast.AugAssign) and isinstance(n.target, ast.Subscript))
            for stmt in loop.body
            for n in ast.walk(stmt)
        )
        if mutates:
            yield (
                loop.lineno, loop.col_offset,
                "state-mutating loop iterates a set: set order is not "
                "deterministic across processes — iterate sorted(...) or an "
                "index array so labels/loads/cut evolve in a pinned order",
            )


class UnseededRandomness(Rule):
    """RPR004 — randomness is an explicit `Generator(seed)`, never global.

    Contract: all randomness in src/ flows through
    `np.random.default_rng(seed)` (or an explicit `Generator`/bit
    generator); the legacy `np.random.*` global API and the stdlib
    `random` module share hidden process-global state, so two call sites
    interleave differently between runs and determinism replay breaks.
    Tests and benchmarks are exempt (they own their process).

    Incident: the reference's convention from its start — every generator,
    ordering and churn workload takes a seed (`ChurnSpec.seed`,
    `order_seed`, `FaultSchedule`'s keyed schedule); the double-run
    determinism suites (shard conformance, serve replay) only hold
    because no src/ module touches global randomness.

    Port reading: torch has a process-global default generator per
    device, which JAX does not.  Reseeding it (`torch.manual_seed`,
    `torch.seed`, `torch.cuda.manual_seed*`) is flagged, and so is every
    draw from it: `torch.rand`, `randn`, `randint`, `randperm`, `normal`,
    `bernoulli`, `multinomial` and the in-place samplers (`.uniform_`,
    `.normal_`, `.bernoulli_`, `.random_`, `.exponential_`) called without
    a `generator=` — the port's explicit `torch.Generator(...).
    manual_seed(seed)` is the counterpart of `default_rng(seed)`.
    """

    id = "RPR004"
    title = "unseeded-randomness"
    exempt = ("tests/*", "benchmarks/*", "examples/*")

    _ALLOWED_NP = frozenset({
        "default_rng", "Generator", "BitGenerator", "SeedSequence",
        "PCG64", "PCG64DXSM", "Philox", "SFC64", "MT19937",
    })
    #: calls that reseed torch's process-global generators
    _TORCH_SEEDERS = frozenset({
        "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
        "torch.random.seed", "torch.cuda.seed", "torch.cuda.seed_all",
    })
    #: draws from the default generator unless `generator=` is passed
    _TORCH_SAMPLERS = frozenset({
        "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
        "torch.normal", "torch.bernoulli", "torch.multinomial",
    })
    _INPLACE_SAMPLERS = frozenset({
        "uniform_", "normal_", "bernoulli_", "random_", "exponential_",
    })

    def check(self, mi):
        aliases = _alias_map(mi.tree)
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.ImportFrom) and node.module == "random":
                yield (
                    node.lineno, node.col_offset,
                    "stdlib `random` shares hidden global state: use "
                    "np.random.default_rng(seed) (explicit, replayable)",
                )
            elif isinstance(node, ast.Call):
                yield from self._check_torch_call(node, aliases)
            elif isinstance(node, ast.Attribute) and not isinstance(
                getattr(node, "parent", None), ast.Attribute
            ):
                qual = _qualify(node, aliases)
                if qual is None:
                    continue
                if qual.startswith("numpy.random."):
                    tail = qual.split(".")[2]
                    if tail not in self._ALLOWED_NP:
                        yield (
                            node.lineno, node.col_offset,
                            f"legacy global-state API np.random.{tail}: use "
                            "np.random.default_rng(seed) so the stream is "
                            "explicit and replayable",
                        )
                elif qual.startswith("random.") and aliases.get("random") == "random":
                    tail = qual.split(".")[1]
                    if tail not in ("Random", "SystemRandom"):
                        yield (
                            node.lineno, node.col_offset,
                            f"stdlib random.{tail} uses hidden process-global "
                            "state: use np.random.default_rng(seed)",
                        )

    @staticmethod
    def _passes_generator(call: ast.Call) -> bool:
        return any(
            kw.arg == "generator"
            and not (isinstance(kw.value, ast.Constant) and kw.value.value is None)
            for kw in call.keywords
        )

    def _check_torch_call(self, call: ast.Call, aliases):
        qual = _qualify(call.func, aliases)
        if qual in self._TORCH_SEEDERS or (
            qual is not None and qual.startswith("torch.cuda.manual_seed")
        ):
            yield (
                call.lineno, call.col_offset,
                f"{qual} reseeds torch's process-global generator: seed an "
                "explicit torch.Generator(...).manual_seed(seed) and pass it",
            )
        elif qual in self._TORCH_SAMPLERS and not self._passes_generator(call):
            yield (
                call.lineno, call.col_offset,
                f"{qual} without generator= draws from torch's process-global "
                "generator: pass an explicit torch.Generator",
            )
        elif (
            isinstance(call.func, ast.Attribute)
            and call.func.attr in self._INPLACE_SAMPLERS
            and not self._passes_generator(call)
        ):
            yield (
                call.lineno, call.col_offset,
                f".{call.func.attr}() without generator= draws from torch's "
                "process-global generator: pass an explicit torch.Generator",
            )


class DurableWrite(Rule):
    """RPR005 — checkpoint/packed-format writes are tmp+fsync+os.replace.

    Contract: in the durable-write modules (checkpoint stores, the packed
    graph format, METIS writers) a final artifact is never `open()`-ed
    for writing directly.  Write to a `*.tmp` sibling, `flush()` +
    `os.fsync()`, then `os.replace()` onto the final name — a crash
    mid-write leaves the previous complete file or the new complete file,
    never a torn one.  `os.replace` without an fsync in the same function
    is a durability hole (the rename can hit disk before the data);
    `os.rename` is not atomic-overwrite on all platforms.

    Incident (the reference's): this pattern was built into
    core/checkpoint.py (`save_checkpoint`) after designing for
    SIGKILL-mid-run crash tests; train/checkpoint.py predated it and
    renamed un-fsynced npz files into place — exactly the torn-checkpoint
    class the pattern exists to kill.

    Approximation: "written under a durable path" is detected textually —
    a write-mode `open()` whose path expression does not mention ``tmp``.
    Scratch spill files that are deleted before return should carry a
    ``tmp`` marker in their name (which also documents them on disk).
    """

    id = "RPR005"
    title = "durable-write"
    modules = (
        "core/checkpoint.py",
        "train/checkpoint.py",
        "graphs/stream_io.py",
        "graphs/io.py",
    )

    def check(self, mi):
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name) and node.func.id == "open":
                mode = _call_mode(node)
                if mode and mode[0] in "wxa" and node.args:
                    path_text = mi.expr_text(node.args[0])
                    if "tmp" not in path_text.lower():
                        yield (
                            node.lineno, node.col_offset,
                            "durable artifact opened for write directly: write "
                            "to a '*.tmp' sibling, flush+os.fsync, then "
                            "os.replace onto the final name "
                            "(core/checkpoint.py::save_checkpoint)",
                        )
                continue
            dotted = _dotted(node.func)
            if dotted == "os.rename":
                yield (
                    node.lineno, node.col_offset,
                    "os.rename is not atomic-overwrite everywhere: use "
                    "os.replace (and fsync the data first)",
                )
            elif dotted == "os.replace":
                scope = mi.enclosing(node, *_FUNC) or mi.tree
                has_fsync = any(
                    isinstance(n, ast.Call) and _dotted(n.func) == "os.fsync"
                    for n in ast.walk(scope)
                )
                if not has_fsync:
                    yield (
                        node.lineno, node.col_offset,
                        "os.replace without os.fsync in the same function: the "
                        "rename can reach disk before the data — fsync the tmp "
                        "file before replacing",
                    )


class ExceptionDiscipline(Rule):
    """RPR006 — no silent swallows; raised-while-handling chains `from`.

    Contract: no bare `except:` (it eats KeyboardInterrupt/SystemExit and
    wedges worker shutdown); no `except Exception: pass` (a worker loop
    that swallows everything serves wrong answers instead of failing
    loudly — narrow the type or record the error); a new exception raised
    inside a handler chains `from err` (root cause preserved for the
    cross-thread re-raise) or `from None` (explicitly severed).

    Incident (the reference's): the lifecycle work — `ShardWorkerError`
    and the serve session both promise the *root cause* surfaces on the
    main thread; one unchained re-raise anywhere in the worker path breaks
    that promise silently.
    """

    id = "RPR006"
    title = "exception-discipline"

    def check(self, mi):
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.ExceptHandler):
                yield from self._check_handler(node)
            elif isinstance(node, ast.Raise):
                yield from self._check_raise(mi, node)

    @staticmethod
    def _broad(type_node: "ast.AST | None") -> bool:
        if type_node is None:
            return True
        names = []
        if isinstance(type_node, ast.Tuple):
            names = [getattr(e, "id", None) for e in type_node.elts]
        else:
            names = [getattr(type_node, "id", None)]
        return any(n in ("Exception", "BaseException") for n in names)

    def _check_handler(self, handler: ast.ExceptHandler):
        if handler.type is None:
            yield (
                handler.lineno, handler.col_offset,
                "bare except: catches KeyboardInterrupt/SystemExit and wedges "
                "shutdown — catch a concrete exception type",
            )
            return
        body_is_silent = all(
            isinstance(s, ast.Pass)
            or (isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant)
                and s.value.value is Ellipsis)
            for s in handler.body
        )
        if body_is_silent and self._broad(handler.type):
            yield (
                handler.lineno, handler.col_offset,
                "except Exception: pass swallows every failure silently — "
                "narrow the exception type or record/re-raise the error",
            )

    @staticmethod
    def _check_raise(mi, node: ast.Raise):
        if not isinstance(node.exc, ast.Call) or node.cause is not None:
            return
        nearest = mi.enclosing(node, ast.ExceptHandler, *_FUNC)
        if isinstance(nearest, ast.ExceptHandler):
            yield (
                node.lineno, node.col_offset,
                "new exception raised while handling another without `from`: "
                "chain `from err` (preserve the root cause for cross-thread "
                "re-raise) or `from None` (explicitly sever)",
            )


class BracketProtocol(Rule):
    """RPR007 — every `.stage(...)` pairs with `.commit(...)`.

    Contract: `IncrementalCut` maintains the exact cut as a two-phase
    bracket — `stage` charges the old labels, `commit` recharges under
    the new ones.  A function that stages a receiver must also commit
    that same receiver: an unmatched stage leaves the resident cut
    permanently wrong (and `apply_edge_delta` refuses to run mid-bracket,
    so the serve mutation path deadlocks behind it).

    Incident (the reference's): the stage→detach→partition→commit core
    was factored into `MicroRestreamer` precisely so the bracket lives in
    one place; this rule keeps new call sites from reopening it half-way.

    Approximation: pairing is checked per enclosing function by receiver
    expression text (`self.cm.stage` ↔ `self.cm.commit`), not per control
    -flow path.
    """

    id = "RPR007"
    title = "bracket-protocol"

    def check(self, mi):
        funcs = [n for n in ast.walk(mi.tree) if isinstance(n, _FUNC)]
        for fn in funcs:
            stages: list[tuple[str, ast.Call]] = []
            commits: set[str] = set()
            for node in ast.walk(fn):
                # stay within this def: nested defs are their own scope
                if node is not fn and isinstance(node, _FUNC):
                    continue
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and mi.enclosing(node, *_FUNC) is fn
                ):
                    recv = mi.expr_text(node.func.value)
                    if node.func.attr == "stage":
                        stages.append((recv, node))
                    elif node.func.attr == "commit":
                        commits.add(recv)
            for recv, call in stages:
                if recv not in commits:
                    yield (
                        call.lineno, call.col_offset,
                        f"{recv}.stage(...) has no matching {recv}.commit(...) "
                        "in this function: an unmatched stage leaves the "
                        "incremental cut permanently wrong",
                    )


class StreamOpenDiscipline(Rule):
    """RPR008 — stream reads in graphs/ go through the retrying opener.

    Contract: graph stream files live on storage that fails transiently
    (the reference's fault model); every read-side `open()` in graphs/ routes
    through the `opener=`/`RetryPolicy` machinery (`_retrying`,
    `_read_retrying`, `open_stream`) so transient errors are retried,
    counted into `StreamStats.io_retries`, and injectable by
    `FaultyOpener`.  A raw `open()` bypasses retry, accounting *and*
    fault injection — the tests that prove IO hardening never see it.

    Incident (the reference's): `opener`/`retry` were threaded through
    every reader and retry counts pinned across scan+workers+merge; a raw
    open in a new reader silently opts out of all of it.
    """

    id = "RPR008"
    title = "stream-open-discipline"
    modules = ("graphs/*.py",)

    @staticmethod
    def _routed(mi, node: ast.Call) -> bool:
        """open() already wrapped by the retry machinery: an enclosing call
        to `_retrying` (the `_retrying(lambda: open(...), policy)` idiom)."""
        cur = getattr(node, "parent", None)
        while cur is not None:
            if isinstance(cur, ast.Call):
                fname = getattr(cur.func, "id", None) or getattr(
                    cur.func, "attr", None
                )
                if fname == "_retrying":
                    return True
            cur = getattr(cur, "parent", None)
        return False

    def check(self, mi):
        for node in ast.walk(mi.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "open"
            ):
                continue
            mode = _call_mode(node)
            if mode is not None and mode[0] in "wxa":
                continue  # write side is RPR005's jurisdiction
            if self._routed(mi, node):
                continue
            yield (
                node.lineno, node.col_offset,
                "raw open() on a stream read path: route through the "
                "RetryPolicy-aware opener (opener=..., _retrying / "
                "_read_retrying / open_stream) so transient IO errors retry, "
                "count into io_retries, and stay fault-injectable",
            )


RULES: "tuple[Rule, ...]" = (
    NoEagerHeavyImports(),
    ThreadLifecycle(),
    DeterministicReduction(),
    UnseededRandomness(),
    DurableWrite(),
    ExceptionDiscipline(),
    BracketProtocol(),
    StreamOpenDiscipline(),
)


def get_rule(rule_id: str) -> Rule:
    for r in RULES:
        if r.id == rule_id:
            return r
    raise KeyError(rule_id)
