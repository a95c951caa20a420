"""The concurrency model — thread topology and lock-set machinery, a copy
of the JAX package's ``analysis/concurrency.py``.

The shared substrate under ``analysis/rules_conc.py`` (the C101–C503
pack) and ``obs/lockwatch.py``'s runtime reconciliation. Pure AST and
stdlib: nothing here imports torch or jax, or the rest of the package.
Lock ids, creation sites and order edges are the JAX package's, so both
packages build the same model from the same sources.

The model follows the RacerD lineage: a *compositional* lock-set
analysis with no whole-program may-alias reasoning. Three artifacts come
out of a project build:

- **Thread topology** — which functions can run on which thread roots.
  Roots are discovered, not declared: ``threading.Thread(target=…)`` /
  ``threading.Timer``, ``ThreadingHTTPServer`` handler classes, and
  ``signal.signal`` handlers. The implicit ``main`` root reaches public
  functions (and dunders), anything called at module top level, and
  ``atexit`` hooks; underscore-private functions are reachable only
  where a resolvable call reaches them. A root is *multi-instance*
  when its ``Thread(...)`` call sits inside a loop or comprehension
  (a dispatcher pool counts as ≥2 writers by itself).
- **Lock census + lock-order graph** — every ``threading.Lock/RLock/
  Condition/Semaphore`` creation gets a stable id
  (``path:Class.attr`` / ``path:global`` / ``path:fn.local``) and a
  creation *site* (``path:lineno``) — the join key lockwatch uses to
  map dynamically observed locks back onto this model. Order edges
  come from lexically nested ``with``/``acquire()`` pairs plus one
  interprocedural hop: per-function *may-acquire* summaries propagated
  to fixpoint over resolvable calls (bare names, ``self.method``,
  ``alias.func`` through imports with one ``__init__`` re-export hop).
- **Shared-state census** — writes to ``self.`` attributes, module
  globals (including ``G.attr = …`` / ``G[k] = …`` mutation through a
  global name), and closure cells, each annotated with the lock set
  held at the write and the thread roots that reach the writer.

Known approximations (deliberate): calls through arbitrary attributes
(``self.guard.call``) do not propagate reachability or summaries;
container mutation via method call (``xs.append``) is not a tracked
write; ``release()`` is assumed to unwind in the block it was acquired
in.
"""

import ast

LOCK_FACTORIES = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Semaphore", "threading.BoundedSemaphore",
}
THREAD_FACTORIES = {"threading.Thread", "threading.Timer"}

MAIN_ROOT = "main"

_LOOPS = (ast.For, ast.While, ast.ListComp, ast.SetComp, ast.DictComp,
          ast.GeneratorExp, ast.AsyncFor)


def import_aliases(tree):
    """name -> dotted module/object path, from import statements."""
    aliases = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def dotted(node, aliases):
    """Attribute/Name chain -> dotted path with aliases resolved."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    head = aliases.get(node.id, node.id)
    parts.append(head)
    return ".".join(reversed(parts))


def module_dotted(path):
    """Repo-relative path -> importable dotted name (best effort)."""
    p = path[:-3] if path.endswith(".py") else path
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    return p.replace("/", ".")


class LockDef:
    __slots__ = ("id", "site", "path", "kind")

    def __init__(self, lock_id, site, path, kind):
        self.id, self.site, self.path, self.kind = lock_id, site, path, kind


class ThreadRoot:
    """One discovered thread entry point."""

    __slots__ = ("key", "kind", "path", "target", "multi", "name", "node")

    def __init__(self, key, kind, path, target, multi, name, node):
        self.key, self.kind, self.path = key, kind, path
        self.target, self.multi = target, multi
        self.name, self.node = name, node


class CallRec:
    __slots__ = ("spec", "node", "held", "dotted", "attr", "recv_lock")

    def __init__(self, spec, node, held, dotted=None, attr=None,
                 recv_lock=None):
        self.spec, self.node, self.held = spec, node, held
        self.dotted, self.attr, self.recv_lock = dotted, attr, recv_lock


class WriteRec:
    __slots__ = ("obj", "node", "held")

    def __init__(self, obj, node, held):
        self.obj, self.node, self.held = obj, node, held


class FuncModel:
    __slots__ = ("qualname", "node", "class_name", "path", "decorators",
                 "direct_locks", "edges", "calls", "writes", "local_locks",
                 "local_names", "global_decls", "is_method")

    def __init__(self, qualname, node, class_name, path):
        self.qualname, self.node = qualname, node
        self.class_name, self.path = class_name, path
        self.decorators = []
        self.global_decls = set()
        self.is_method = False
        self.direct_locks = set()
        self.edges = []          # (held_id, acquired_id, node)
        self.calls = []          # [CallRec]
        self.writes = []         # [WriteRec]
        self.local_locks = {}    # name -> lock id
        self.local_names = set()

    @property
    def public(self):
        last = self.qualname.rsplit(".", 1)[-1]
        if last.startswith("__") and last.endswith("__"):
            return True      # dunders run implicitly from user code
        return not last.startswith("_")


class ModuleModel:
    def __init__(self, path, tree):
        self.path = path
        self.tree = tree
        self.dotted = module_dotted(path)
        self.aliases = import_aliases(tree)
        self.funcs = {}            # qualname -> FuncModel
        self.classes = {}          # name -> ClassDef (incl. nested)
        self.locks = {}            # lock id -> LockDef
        self.global_locks = {}     # global name -> lock id
        self.attr_locks = {}       # (class, attr) -> lock id
        self.global_names = set()  # module-level assigned names
        self.roots = []            # [ThreadRoot]
        self.signal_handlers = []  # (handler FuncModel|None, node)
        self.toplevel_called = set()
        self.reexports = {}        # name -> dotted source (ImportFrom)
        _scan_module(self)

    @property
    def has_threads(self):
        return any(r.kind in ("thread", "httpserver") for r in self.roots)


# -- per-module scan ------------------------------------------------------


def _lock_factory(call, aliases):
    if not isinstance(call, ast.Call):
        return None
    d = dotted(call.func, aliases)
    return d if d in LOCK_FACTORIES else None


def _scan_module(mm):
    tree = mm.tree
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            mm.classes[node.name] = node
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                mm.reexports[a.asname or a.name] = \
                    f"{node.module}.{a.name}"
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name):
                    mm.global_names.add(t.id)
            fac = _lock_factory(getattr(node, "value", None), mm.aliases)
            if fac:
                for t in targets:
                    if isinstance(t, ast.Name):
                        lid = f"{mm.path}:{t.id}"
                        mm.locks[lid] = LockDef(
                            lid, f"{mm.path}:{node.value.lineno}",
                            mm.path, fac)
                        mm.global_locks[t.id] = lid
        elif isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            base = node.value.func
            while isinstance(base, ast.Attribute):
                base = base.value
            if isinstance(base, ast.Name):
                mm.toplevel_called.add(base.id)
            d = dotted(node.value.func, mm.aliases)
            if d == "atexit.register" and node.value.args:
                a0 = node.value.args[0]
                if isinstance(a0, ast.Name):
                    mm.toplevel_called.add(a0.id)

    # Class-attribute locks: ``self.X = threading.Lock()`` in any method.
    for cname, cnode in mm.classes.items():
        for meth in cnode.body:
            if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for st in ast.walk(meth):
                if not isinstance(st, ast.Assign):
                    continue
                fac = _lock_factory(st.value, mm.aliases)
                if not fac:
                    continue
                for t in st.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        lid = f"{mm.path}:{cname}.{t.attr}"
                        mm.locks[lid] = LockDef(
                            lid, f"{mm.path}:{st.value.lineno}",
                            mm.path, fac)
                        mm.attr_locks[(cname, t.attr)] = lid

    # Function models (module functions, methods, nested defs).
    def visit_scope(body, prefix, class_name, in_class):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{node.name}" if prefix else node.name
                fm = FuncModel(q, node, class_name, mm.path)
                fm.is_method = in_class
                fm.decorators = [dotted(d, mm.aliases) or
                                 getattr(d, "attr", None) or
                                 (d.id if isinstance(d, ast.Name) else None)
                                 for d in node.decorator_list]
                mm.funcs[q] = fm
                visit_scope(node.body, q + ".", class_name, False)
            elif isinstance(node, ast.ClassDef):
                visit_scope(node.body, f"{node.name}.", node.name, True)
    visit_scope(tree.body, "", None, False)

    for fm in list(mm.funcs.values()):
        _walk_function(mm, fm)

    # Thread / signal / http-server roots anywhere in the module.
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        d = dotted(node.func, mm.aliases)
        if d in THREAD_FACTORIES:
            target = None
            for kw in node.keywords:
                if kw.arg in ("target", "function"):
                    target = kw.value
            if target is None and d.endswith("Timer") and len(node.args) > 1:
                target = node.args[1]
            name = None
            for kw in node.keywords:
                if kw.arg == "name" and isinstance(kw.value, ast.Constant) \
                        and isinstance(kw.value.value, str):
                    name = kw.value.value
            spec = _target_spec(target, mm)
            key = f"thread:{mm.path}:{node.lineno}"
            mm.roots.append(ThreadRoot(
                key, "thread", mm.path, spec,
                _in_loop(tree, node), name, node))
        elif d and d.endswith("ThreadingHTTPServer") and len(node.args) >= 2:
            h = node.args[1]
            if isinstance(h, ast.Name) and h.id in mm.classes:
                for meth in mm.classes[h.id].body:
                    if isinstance(meth, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                        key = f"httpserver:{mm.path}:{node.lineno}"
                        mm.roots.append(ThreadRoot(
                            key, "httpserver", mm.path,
                            ("qual", f"{h.id}.{meth.name}"), True,
                            h.id, node))
        elif d == "signal.signal" and len(node.args) >= 2:
            handler = node.args[1]
            spec = _target_spec(handler, mm)
            key = f"signal:{mm.path}:{node.lineno}"
            mm.roots.append(ThreadRoot(
                key, "signal", mm.path, spec, False, None, node))
            mm.signal_handlers.append((spec, handler, node))


def _target_spec(target, mm):
    """A thread-target / handler expression -> resolution spec."""
    if target is None:
        return None
    if isinstance(target, ast.Name):
        return ("name", target.id)
    if isinstance(target, ast.Attribute) and \
            isinstance(target.value, ast.Name) and target.value.id == "self":
        # The enclosing class is unknown at the module-wide walk; the
        # project phase matches the method name against every class.
        return ("selfattr", target.attr)
    if isinstance(target, ast.Lambda):
        q = f"<lambda>:{target.lineno}"
        fm = FuncModel(q, target, None, mm.path)
        mm.funcs[q] = fm
        _walk_function(mm, fm)
        return ("qual", q)
    d = dotted(target, mm.aliases)
    return ("dotted", d) if d else None


def _in_loop(tree, node):
    """Whether ``node`` sits inside a loop or comprehension."""
    found = [False]

    def rec(n, depth):
        if n is node:
            found[0] = depth > 0
            return True
        bump = 1 if isinstance(n, _LOOPS) else 0
        for c in ast.iter_child_nodes(n):
            if rec(c, depth + bump):
                return True
        return False
    rec(tree, 0)
    return found[0]


# -- per-function lock-set walk -------------------------------------------


def _walk_function(mm, fm):
    node = fm.node
    body = node.body if not isinstance(node, ast.Lambda) else [
        ast.Expr(value=node.body)]
    # Local name census (params + any Name store) — shadow detection.
    args = getattr(node, "args", None)
    if args is not None:
        for a in (args.posonlyargs + args.args + args.kwonlyargs
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            fm.local_names.add(a.arg)
    own_stmts = _own_statements(body)
    for st in own_stmts:
        for n in ast.walk(st):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                fm.local_names.add(n.id)
    fm.global_decls = set()
    for st in own_stmts:
        for n in ast.walk(st):
            if isinstance(n, ast.Global):
                fm.global_decls.update(n.names)
    # Function-local lock creations.
    for st in own_stmts:
        for n in ast.walk(st):
            if isinstance(n, ast.Assign):
                fac = _lock_factory(n.value, mm.aliases)
                if fac:
                    for t in n.targets:
                        if isinstance(t, ast.Name):
                            lid = f"{mm.path}:{fm.qualname}.{t.id}"
                            mm.locks[lid] = LockDef(
                                lid, f"{mm.path}:{n.value.lineno}",
                                mm.path, fac)
                            fm.local_locks[t.id] = lid
    _walk_body(mm, fm, body, ())


def _own_statements(body):
    """Statements of a function excluding nested function bodies."""
    out = []

    def rec(stmts):
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            out.append(st)
            for field in ("body", "orelse", "finalbody"):
                rec(getattr(st, field, []) or [])
            for h in getattr(st, "handlers", []) or []:
                rec(h.body)
    rec(body)
    return out


def resolve_lock(mm, fm, expr):
    """Lock id for a Name/Attribute expression, else None.

    Lookup order: function locals (chained through enclosing functions
    by qualname prefix), ``self.attr`` against the enclosing class,
    module globals, then ``alias.attr`` as an extern placeholder the
    project phase resolves against other modules' global locks.
    """
    if isinstance(expr, ast.Name):
        f = fm
        while f is not None:
            if expr.id in f.local_locks:
                return f.local_locks[expr.id]
            outer = f.qualname.rsplit(".", 1)[0] \
                if "." in f.qualname else None
            f = mm.funcs.get(outer) if outer else None
        return mm.global_locks.get(expr.id)
    if isinstance(expr, ast.Attribute):
        if isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                and fm.class_name:
            return mm.attr_locks.get((fm.class_name, expr.attr))
        d = dotted(expr, mm.aliases)
        if d:
            return "extern::" + d
    return None


def _walk_body(mm, fm, stmts, held):
    open_locks = []
    for st in stmts:
        h = held + tuple(open_locks)
        acq = _acquire_target(mm, fm, st, "acquire")
        rel = _acquire_target(mm, fm, st, "release")
        if acq is not None:
            _note_acquire(fm, h, acq, st)
            open_locks.append(acq)
            continue
        if rel is not None:
            if rel in open_locks:
                open_locks.remove(rel)
            continue
        _walk_stmt(mm, fm, st, h)


def _acquire_target(mm, fm, st, method):
    if not (isinstance(st, ast.Expr) and isinstance(st.value, ast.Call)):
        return None
    call = st.value
    if not (isinstance(call.func, ast.Attribute)
            and call.func.attr == method):
        return None
    return resolve_lock(mm, fm, call.func.value)


def _note_acquire(fm, held, lock_id, node):
    fm.direct_locks.add(lock_id)
    for h in held:
        if h != lock_id:
            fm.edges.append((h, lock_id, node))


def _walk_stmt(mm, fm, st, held):
    if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return  # separate FuncModels; run with their own (empty) held set
    if isinstance(st, (ast.With, ast.AsyncWith)):
        new = list(held)
        for item in st.items:
            lid = resolve_lock(mm, fm, item.context_expr)
            if lid is not None:
                _note_acquire(fm, tuple(new), lid, item.context_expr)
                new.append(lid)
            else:
                _scan_expr(mm, fm, item.context_expr, tuple(new))
        _walk_body(mm, fm, st.body, tuple(new))
        return
    for field in ("body", "orelse", "finalbody"):
        sub = getattr(st, field, None)
        if sub:
            _walk_body(mm, fm, sub, held)
    for hdl in getattr(st, "handlers", []) or []:
        _walk_body(mm, fm, hdl.body, held)
    if isinstance(st, (ast.If, ast.While)):
        _scan_expr(mm, fm, st.test, held)
    elif isinstance(st, (ast.For, ast.AsyncFor)):
        _scan_expr(mm, fm, st.iter, held)
    elif isinstance(st, (ast.Return, ast.Expr)) and st.value is not None:
        _scan_expr(mm, fm, st.value, held)
    elif isinstance(st, ast.Assign):
        _scan_expr(mm, fm, st.value, held)
        for t in st.targets:
            _note_write(mm, fm, t, st, held, st.value)
    elif isinstance(st, ast.AugAssign):
        _scan_expr(mm, fm, st.value, held)
        _note_write(mm, fm, st.target, st, held, None)
    elif isinstance(st, ast.AnnAssign) and st.value is not None:
        _scan_expr(mm, fm, st.value, held)
        _note_write(mm, fm, st.target, st, held, st.value)
    elif isinstance(st, (ast.Assert, ast.Raise, ast.Delete)):
        for n in ast.iter_child_nodes(st):
            _scan_expr(mm, fm, n, held)


def _note_write(mm, fm, target, st, held, value):
    if _lock_factory(value, mm.aliases):
        return  # installing the sync primitive itself
    base = target
    while isinstance(base, (ast.Subscript, ast.Attribute)) and not (
            isinstance(base, ast.Attribute)
            and isinstance(base.value, ast.Name)):
        base = base.value
    if isinstance(base, ast.Attribute) and isinstance(base.value, ast.Name):
        if base.value.id == "self" and fm.class_name:
            last = fm.qualname.rsplit(".", 1)[-1]
            if last in ("__init__", "__new__", "__del__"):
                return  # happens-before any thread start / after join
            fm.writes.append(WriteRec(
                ("attr", fm.class_name, base.attr), st, held))
            return
        name, direct = base.value.id, False
    elif isinstance(base, ast.Name):
        name, direct = base.id, isinstance(target, ast.Name)
    else:
        return
    if direct and name not in fm.global_decls:
        return  # plain NAME = … without ``global`` is a local bind
    if name in fm.global_decls or (
            not direct and name not in fm.local_names
            and name in mm.global_names):
        fm.writes.append(WriteRec(("global", name), st, held))
        return
    if not direct and name not in fm.local_names:
        # Mutation through a closure cell of an enclosing function.
        outer = fm.qualname
        while "." in outer:
            outer = outer.rsplit(".", 1)[0]
            f = mm.funcs.get(outer)
            if f is None:
                break
            if name in f.local_names:
                fm.writes.append(WriteRec(
                    ("closure", outer, name), st, held))
                return


def _scan_expr(mm, fm, expr, held):
    if expr is None:
        return
    for n in ast.walk(expr):
        if not isinstance(n, ast.Call):
            continue
        d = dotted(n.func, mm.aliases)
        if isinstance(n.func, ast.Name):
            fm.calls.append(CallRec(
                ("name", n.func.id), n, held, dotted=d))
        elif isinstance(n.func, ast.Attribute):
            f = n.func
            if isinstance(f.value, ast.Name) and f.value.id == "self" \
                    and fm.class_name:
                fm.calls.append(CallRec(
                    ("self", fm.class_name, f.attr), n, held,
                    dotted=d, attr=f.attr))
            else:
                fm.calls.append(CallRec(
                    ("dotted", d) if d else ("attr", f.attr), n, held,
                    dotted=d, attr=f.attr,
                    recv_lock=resolve_lock(mm, fm, f.value)))


# -- project phase --------------------------------------------------------


class Project:
    """Cross-module topology: call graph, summaries, order edges, reach."""

    def __init__(self, modules):
        self.mods = {}
        for m in modules:
            tree = getattr(m, "tree", None)
            if tree is None:
                continue
            self.mods[m.path] = ModuleModel(m.path, tree)
        self.by_dotted = {mm.dotted: mm for mm in self.mods.values()}
        self.lock_defs = {}
        self.extern = {}          # "extern::dotted" -> lock id | None
        for mm in self.mods.values():
            self.lock_defs.update(mm.locks)
        self._resolve_externs()
        self.callees = self._call_graph()
        self.summaries = self._fixpoint_summaries()
        self.edges = self._order_edges()
        self.reach = self._reachability()

    # extern lock refs ----------------------------------------------------

    def _extern_lock(self, ref):
        if ref in self.extern:
            return self.extern[ref]
        d = ref[len("extern::"):]
        out = None
        if "." in d:
            mod_part, attr = d.rsplit(".", 1)
            mm = self.by_dotted.get(mod_part)
            if mm is not None:
                out = mm.global_locks.get(attr)
        self.extern[ref] = out
        return out

    def _resolve_externs(self):
        def fix_held(held):
            out = []
            for h in held:
                if h.startswith("extern::"):
                    h = self._extern_lock(h)
                if h is not None:
                    out.append(h)
            return tuple(out)

        for mm in self.mods.values():
            for fm in mm.funcs.values():
                fm.direct_locks = set(fix_held(fm.direct_locks))
                fm.edges = [(a2, b2, n)
                            for a, b, n in fm.edges
                            for a2 in fix_held((a,))
                            for b2 in fix_held((b,))]
                for c in fm.calls:
                    c.held = fix_held(c.held)
                    if c.recv_lock and c.recv_lock.startswith("extern::"):
                        c.recv_lock = self._extern_lock(c.recv_lock)
                for w in fm.writes:
                    w.held = fix_held(w.held)

    # call graph ----------------------------------------------------------

    def resolve_call(self, mm, spec):
        """Call spec -> list of (path, qualname) targets."""
        if spec is None:
            return []
        kind = spec[0]
        if kind == "qual":
            return [(mm.path, spec[1])] if spec[1] in mm.funcs else []
        if kind == "name":
            name = spec[1]
            return [(mm.path, q) for q, f in mm.funcs.items()
                    if (q == name or q.endswith("." + name))
                    and not f.is_method]
        if kind == "self":
            _, cls, meth = spec
            q = f"{cls}.{meth}"
            return [(mm.path, q)] if q in mm.funcs else []
        if kind == "selfattr":
            meth = spec[1]
            return [(mm.path, q) for q, f in mm.funcs.items()
                    if f.is_method and q.endswith("." + meth)]
        if kind == "dotted":
            d = spec[1]
            if d is None or "." not in d:
                return []
            mod_part, name = d.rsplit(".", 1)
            target = self.by_dotted.get(mod_part)
            if target is None:
                return []
            if name in target.funcs:
                return [(target.path, name)]
            # One re-export hop through a package __init__.
            src = target.reexports.get(name)
            if src and "." in src:
                m2, n2 = src.rsplit(".", 1)
                t2 = self.by_dotted.get(m2)
                if t2 is not None and n2 in t2.funcs:
                    return [(t2.path, n2)]
            return []
        return []

    def _call_graph(self):
        callees = {}
        for mm in self.mods.values():
            for q, fm in mm.funcs.items():
                out = set()
                for c in fm.calls:
                    out.update(self.resolve_call(mm, c.spec))
                callees[(mm.path, q)] = out
        return callees

    # may-acquire summaries ----------------------------------------------

    def _fixpoint_summaries(self):
        summaries = {}
        for mm in self.mods.values():
            for q, fm in mm.funcs.items():
                summaries[(mm.path, q)] = set(fm.direct_locks)
        changed = True
        rounds = 0
        while changed and rounds < 50:
            changed, rounds = False, rounds + 1
            for fkey, targets in self.callees.items():
                s = summaries[fkey]
                for t in targets:
                    extra = summaries.get(t, ()) - s
                    if extra:
                        s.update(extra)
                        changed = True
        return summaries

    # lock-order edges ----------------------------------------------------

    def _order_edges(self):
        edges = {}
        for mm in self.mods.values():
            for q, fm in mm.funcs.items():
                for a, b, node in fm.edges:
                    if a != b:
                        edges.setdefault((a, b), (mm.path, node))
                for c in fm.calls:
                    if not c.held:
                        continue
                    for t in self.resolve_call(mm, c.spec):
                        for b in self.summaries.get(t, ()):
                            for a in c.held:
                                if a != b:
                                    edges.setdefault((a, b),
                                                     (mm.path, c.node))
        return edges

    def cycles(self):
        """SCCs of size >= 2 in the lock-order graph, sorted."""
        adj = {}
        for (a, b) in self.edges:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
        index, low, onstk = {}, {}, set()
        stack, out, counter = [], [], [0]

        def strong(v):
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            onstk.add(v)
            for w in sorted(adj.get(v, ())):
                if w not in index:
                    strong(w)
                    low[v] = min(low[v], low[w])
                elif w in onstk:
                    low[v] = min(low[v], index[w])
            if low[v] == index[v]:
                scc = []
                while True:
                    w = stack.pop()
                    onstk.discard(w)
                    scc.append(w)
                    if w == v:
                        break
                if len(scc) > 1:
                    out.append(sorted(scc))
        for v in sorted(adj):
            if v not in index:
                strong(v)
        return sorted(out)

    # thread reachability -------------------------------------------------

    def _root_seeds(self, mm, root):
        return self.resolve_call(mm, root.target)

    def _reachability(self):
        """fkey -> set of root keys that can execute it."""
        reach = {}

        def bfs(seeds, key):
            todo = list(seeds)
            seen = set()
            while todo:
                f = todo.pop()
                if f in seen or f not in self.callees:
                    continue
                seen.add(f)
                reach.setdefault(f, set()).add(key)
                todo.extend(self.callees[f])

        main_seeds = []
        for mm in self.mods.values():
            for q, fm in mm.funcs.items():
                base = q.split(".", 1)[0]
                # Only module-level functions and methods are externally
                # callable; nested defs/lambdas reach a root solely via
                # resolvable calls or thread targets.
                top_level = ("." not in q and not q.startswith("<lambda>")) \
                    or fm.is_method
                if top_level and (fm.public or base in mm.toplevel_called
                                  or q in mm.toplevel_called):
                    main_seeds.append((mm.path, q))
        bfs(main_seeds, MAIN_ROOT)
        for mm in self.mods.values():
            for root in mm.roots:
                bfs(self._root_seeds(mm, root), root.key)
        return reach

    def roots_of(self, path, qualname):
        return self.reach.get((path, qualname), set())

    def root_by_key(self, key):
        for mm in self.mods.values():
            for r in mm.roots:
                if r.key == key:
                    return r
        return None

    # shared-state census -------------------------------------------------

    def shared_writes(self):
        """{(path-scoped object key): [(fkey, WriteRec)]}."""
        objs = {}
        for mm in self.mods.values():
            for q, fm in mm.funcs.items():
                for w in fm.writes:
                    key = (w.obj[0], mm.path) + w.obj[1:]
                    objs.setdefault(key, []).append(((mm.path, q), w))
        return objs


# -- lockwatch reconciliation model ---------------------------------------


def build_project(modules):
    return Project(modules)


def build_lock_model(paths):
    """Static lock model for obs/lockwatch.reconcile: lock census keyed
    by creation site + the C201 order edges. Pure data (JSON-able)."""
    from flake16_framework_tpu_torch.analysis import engine as eng

    mods = [eng.Module(f) for f in eng.iter_py_files(paths)]
    proj = Project([m for m in mods if m.tree is not None])
    return {
        "locks": {lid: {"site": ld.site, "kind": ld.kind}
                  for lid, ld in sorted(proj.lock_defs.items())},
        "edges": sorted([a, b] for (a, b) in proj.edges),
    }


def transitive_closure(edges):
    """{a: set of ids reachable from a} over [a, b] pairs."""
    adj = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
    closure = {}
    for a in adj:
        seen, todo = set(), [a]
        while todo:
            v = todo.pop()
            for w in adj.get(v, ()):
                if w not in seen:
                    seen.add(w)
                    todo.append(w)
        closure[a] = seen
    return closure


def find_edge_cycle(edges):
    """One cycle (as a list of nodes) in [a, b] pairs, or None."""
    adj = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
    WHITE, GREY, BLACK = 0, 1, 2
    color = {v: WHITE for v in adj}
    parent = {}

    def dfs(v):
        color[v] = GREY
        for w in sorted(adj.get(v, ())):
            if color.get(w, WHITE) == WHITE:
                parent[w] = v
                hit = dfs(w)
                if hit:
                    return hit
            elif color.get(w) == GREY:
                cyc, cur = [w], v
                while cur != w:
                    cyc.append(cur)
                    cur = parent[cur]
                cyc.reverse()
                return cyc
        color[v] = BLACK
        return None

    for v in sorted(adj):
        if color[v] == WHITE:
            hit = dfs(v)
            if hit:
                return hit
    return None
