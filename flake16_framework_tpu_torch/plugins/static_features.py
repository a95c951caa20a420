"""Static per-test-function features as a pure ``ast`` walk, no radon (a
copy of the JAX package's ``plugins/static_features.py``).

The 7 features, in tests.json column order (constants.FEATURE_NAMES[9:16]):
AST Depth, Assertions, External Modules, Halstead Volume, Cyclomatic
Complexity, Test Lines of Code, Maintainability.

Definitions follow the classic formulations of these metrics (radon 5.1
implements the same):

- AST Depth: maximum nesting depth of the function's AST.
- Assertions: ``assert`` statements plus unittest-style ``*.assert*()`` /
  ``*.fail*()`` method calls.
- External Modules: distinct absolute top-level modules imported by the
  test's module (relative imports are project-internal by construction).
- Halstead Volume: (N1+N2) * log2(n1+n2) over operators/operands.
- Cyclomatic Complexity: 1 + decision points (if/elif, loops, except,
  boolean-operator branches, ternaries, comprehension filters).
- Test Lines of Code: the function's source extent.
- Maintainability: the standard 0-100 maintainability index
  max(0, 100*(171 - 5.2 ln V - 0.23 CC - 16.2 ln LoC)/171).
"""

import ast
import math

_DECISION_NODES = (ast.If, ast.For, ast.While, ast.AsyncFor, ast.IfExp,
                   ast.ExceptHandler, ast.Assert)
_OPERAND_NODES = (ast.Name, ast.Constant, ast.arg)
_OPERATOR_NODES = (ast.operator, ast.boolop, ast.unaryop, ast.cmpop,
                   ast.Assign, ast.AugAssign, ast.AnnAssign, ast.Call,
                   ast.Subscript, ast.Attribute)


def _max_depth(node, depth=0):
    children = list(ast.iter_child_nodes(node))
    if not children:
        return depth
    return max(_max_depth(c, depth + 1) for c in children)


def _assertions(fn):
    count = 0
    for node in ast.walk(fn):
        if isinstance(node, ast.Assert):
            count += 1
        elif isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else (
                f.id if isinstance(f, ast.Name) else ""
            )
            if name.startswith(("assert", "fail")):
                count += 1
    return count


def _halstead_volume(fn):
    operators, operands = [], []
    for node in ast.walk(fn):
        if isinstance(node, ast.BoolOp):
            operators += [type(node.op).__name__] * (len(node.values) - 1)
        elif isinstance(node, ast.Compare):
            operators += [type(op).__name__ for op in node.ops]
        elif isinstance(node, (ast.BinOp, ast.UnaryOp)):
            operators.append(type(node.op).__name__)
        elif isinstance(node, _OPERATOR_NODES):
            operators.append(type(node).__name__)
        elif isinstance(node, _OPERAND_NODES):
            if isinstance(node, ast.Name):
                operands.append(node.id)
            elif isinstance(node, ast.arg):
                operands.append(node.arg)
            else:
                operands.append(repr(node.value))
    vocab = len(set(operators)) + len(set(operands))
    length = len(operators) + len(operands)
    return length * math.log2(vocab) if vocab > 1 else 0.0


def _cyclomatic(fn):
    cc = 1
    for node in ast.walk(fn):
        if isinstance(node, _DECISION_NODES):
            cc += 1
        elif isinstance(node, ast.BoolOp):
            cc += len(node.values) - 1
        elif isinstance(node, ast.comprehension):
            cc += 1 + len(node.ifs)
    return cc


def _maintainability(volume, cc, loc):
    mi = (171.0 - 5.2 * math.log(max(volume, 1.0))
          - 0.23 * cc - 16.2 * math.log(max(loc, 1))) * 100.0 / 171.0
    return max(0.0, mi)


def module_external_imports(tree):
    """Distinct absolute top-level modules imported anywhere in the module."""
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            if node.module:
                mods.add(node.module.split(".")[0])
    return mods


def function_features(fn, n_external):
    """The 7-tuple for one test function node (order: FEATURE_NAMES[9:16])."""
    volume = _halstead_volume(fn)
    cc = _cyclomatic(fn)
    loc = (fn.end_lineno or fn.lineno) - fn.lineno + 1
    return (
        float(_max_depth(fn)),
        float(_assertions(fn)),
        float(n_external),
        float(volume),
        float(cc),
        float(loc),
        float(_maintainability(volume, cc, loc)),
    )


class ModuleAnalyzer:
    """Per-file cache: parse once, serve per-function feature tuples."""

    def __init__(self):
        self._cache = {}

    def _module(self, path):
        if path not in self._cache:
            with open(path, "r", encoding="utf-8", errors="replace") as fd:
                tree = ast.parse(fd.read(), filename=path)
            fns = {}
            for node in ast.walk(tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    fns[(node.name, node.lineno)] = node
            self._cache[path] = (fns, len(module_external_imports(tree)))
        return self._cache[path]

    def features_for(self, path, name, firstlineno):
        """Feature tuple for the function ``name`` whose ``def`` is at (or
        nearest at-or-before) ``firstlineno`` — decorator offsets make exact
        line equality unreliable across Python versions."""
        fns, n_external = self._module(path)
        candidates = [ln for (nm, ln) in fns if nm == name]
        if not candidates:
            return None
        best = min(candidates, key=lambda ln: abs(ln - firstlineno))
        return function_features(fns[(name, best)], n_external)
