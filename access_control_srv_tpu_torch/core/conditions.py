"""Rule condition evaluation.

The reference evaluates rule conditions as raw JavaScript via ``eval`` with
``target`` and ``context`` in scope, calling the result if it is a function
(reference: src/core/utils.ts:47-56 — arbitrary code, trusted-policy
assumption).  This framework treats policy documents as *less* trusted:
conditions are **restricted Python** validated against an AST whitelist
before evaluation:

- only expression/comprehension/lambda/def-of-``check`` constructs;
- no imports, no ``exec``/``eval``/``compile``/``getattr`` calls;
- no dunder or underscore-prefixed attribute or name access (blocks the
  ``().__class__.__base__.__subclasses__()`` escape family).

A condition is either a single expression over ``request`` / ``target`` /
``context``, or a multi-line snippet defining
``check(request, target, context)``.  Failures during validation or
evaluation propagate as exceptions; the engine converts them into
deny-by-default responses (reference: src/core/accessController.ts:259-270).
"""

from __future__ import annotations

import ast
import re
from typing import Any


class DotView:
    """Attribute-style read-only view over nested dicts/lists so conditions
    can be written ``context.resources[0].address`` against JSON-like
    context data.  Missing attributes raise, mirroring the reference where a
    broken condition throws inside ``eval`` and yields DENY."""

    __slots__ = ("_obj",)

    def __init__(self, obj: Any):
        object.__setattr__(self, "_obj", obj)

    def __getattr__(self, name: str):
        obj = object.__getattribute__(self, "_obj")
        if isinstance(obj, dict):
            if name in obj:
                return _wrap(obj[name])
            raise AttributeError(f"context has no attribute {name!r}")
        return _wrap(getattr(obj, name))

    def __getitem__(self, key):
        return _wrap(object.__getattribute__(self, "_obj")[key])

    def __iter__(self):
        return (_wrap(x) for x in object.__getattribute__(self, "_obj"))

    def __len__(self):
        return len(object.__getattribute__(self, "_obj"))

    def __contains__(self, item):
        return item in object.__getattribute__(self, "_obj")

    def __eq__(self, other):
        mine = object.__getattribute__(self, "_obj")
        if isinstance(other, DotView):
            other = object.__getattribute__(other, "_obj")
        return mine == other

    def __bool__(self):
        return bool(object.__getattribute__(self, "_obj"))

    def __repr__(self):
        return f"DotView({object.__getattribute__(self, '_obj')!r})"

    def raw(self):
        return object.__getattribute__(self, "_obj")


def _wrap(value: Any):
    if isinstance(value, (dict, list)):
        return DotView(value) if isinstance(value, dict) else [_wrap(v) for v in value]
    return value


class ConditionBudgetExceeded(RuntimeError):
    code = 500


# Caps on work done inside C-level builtins, where the sys.settrace budget
# cannot see: max items any builtin may consume from an iterable, max length
# of a sequence produced by +/*, max bit-length of an integer produced by
# arithmetic.  Exceeding any of them raises ConditionBudgetExceeded, which
# the engine converts into deny-by-default.
_MAX_ITER_ITEMS = 100_000
_MAX_SEQ_LEN = 1_000_000
_MAX_INT_BITS = 65_536
# cumulative sequence bytes one evaluation may allocate through the guarded
# ops: bounds loops that build many individually-legal sequences
_MAX_TOTAL_ALLOC = 8 * _MAX_SEQ_LEN

_ALLOC_STATE = __import__("threading").local()


def _charge_alloc(n: int) -> None:
    remaining = getattr(_ALLOC_STATE, "remaining", None)
    if remaining is None:
        return
    remaining -= max(n, 0)
    if remaining < 0:
        raise ConditionBudgetExceeded("condition allocated too much memory")
    _ALLOC_STATE.remaining = remaining


def _capped(iterable):
    """Bound how many items a C-level consumer (sum/list/dict/...) may pull
    from ``iterable``; sized inputs are checked up front, lazy ones are
    wrapped in a counting generator."""
    try:
        n = len(iterable)
    except TypeError:
        def gen():
            for i, item in enumerate(iterable):
                if i >= _MAX_ITER_ITEMS:
                    raise ConditionBudgetExceeded(
                        "condition iterated over too many items"
                    )
                yield item
        return gen()
    except OverflowError:
        raise ConditionBudgetExceeded("condition iterated over too many items")
    if n > _MAX_ITER_ITEMS:
        raise ConditionBudgetExceeded("condition iterated over too many items")
    return iterable


def _capped_consumer(fn):
    def wrapper(iterable=(), *args, **kwargs):
        return fn(_capped(iterable), *args, **kwargs)
    wrapper.__name__ = fn.__name__
    return wrapper


def _capped_minmax(fn):
    def wrapper(*args, **kwargs):
        if len(args) == 1:
            return fn(_capped(args[0]), **kwargs)
        return fn(*args, **kwargs)
    wrapper.__name__ = fn.__name__
    return wrapper


def _safe_sum(iterable=(), start=0):
    # a list/tuple start turns sum() into C-level sequence concatenation
    # ('sum([s, s], [])' == 's + s' with no _g_add in sight)
    if not isinstance(start, (int, float)):
        raise ConditionBudgetExceeded(
            "sum() start must be numeric in conditions"
        )
    return sum(_capped(iterable), start)


def _capped_dict(arg=None, **kwargs):
    if arg is None:
        return dict(**kwargs)
    if isinstance(arg, dict):
        return dict(arg, **kwargs)
    return dict(_capped(arg), **kwargs)


def _seq_len(value) -> int | None:
    if isinstance(value, (str, bytes, list, tuple)):
        return len(value)
    return None


def _guard_int(value):
    if isinstance(value, int) and value.bit_length() > _MAX_INT_BITS:
        raise ConditionBudgetExceeded("condition produced an oversized integer")
    return value


def _g_add(a, b):
    la, lb = _seq_len(a), _seq_len(b)
    if la is not None and lb is not None:
        if la + lb > _MAX_SEQ_LEN:
            raise ConditionBudgetExceeded(
                "condition produced an oversized sequence"
            )
        _charge_alloc(la + lb)
    return a + b


def _g_mul(a, b):
    for seq, times in ((a, b), (b, a)):
        n = _seq_len(seq)
        if n is not None and isinstance(times, int):
            produced = n * max(times, 0)
            if produced > _MAX_SEQ_LEN:
                raise ConditionBudgetExceeded(
                    "condition produced an oversized sequence"
                )
            _charge_alloc(produced)
    if isinstance(a, int) and isinstance(b, int):
        if a.bit_length() + b.bit_length() > _MAX_INT_BITS:
            raise ConditionBudgetExceeded(
                "condition produced an oversized integer"
            )
    return a * b


_WIDE_FORMAT = re.compile(r"\d{7}")
# '%*d' / '%.*f' take the pad width from the args tuple, sidestepping any
# scan of the format string itself
_STAR_FORMAT = re.compile(r"%[^a-zA-Z%]*\*")


def _g_mod(a, b):
    # '%'-formatting can allocate via width specifiers ('%099999999999d')
    if isinstance(a, (str, bytes)):
        text = a if isinstance(a, str) else a.decode("latin1", "ignore")
        if _WIDE_FORMAT.search(text) or _STAR_FORMAT.search(text):
            raise ConditionBudgetExceeded(
                "condition used an oversized or dynamic format width"
            )
        result = a % b
        _charge_alloc(len(result))
        return result
    return a % b


def _g_replace(obj, *args):
    if (
        isinstance(obj, (str, bytes))
        and len(args) >= 2
        and isinstance(args[0], type(obj))
        and isinstance(args[1], type(obj))
    ):
        old, new = args[0], args[1]
        occurrences = obj.count(old) if len(old) > 0 else len(obj) + 1
        if len(args) > 2 and isinstance(args[2], int) and args[2] >= 0:
            occurrences = min(occurrences, args[2])
        projected = len(obj) + occurrences * (len(new) - len(old))
        if projected > _MAX_SEQ_LEN:
            raise ConditionBudgetExceeded(
                "condition produced an oversized sequence"
            )
        _charge_alloc(max(projected, len(obj)))
    return obj.replace(*args)


def _g_join(obj, *args):
    if isinstance(obj, (str, bytes)) and len(args) == 1:
        items = list(_capped(args[0]))
        total = len(obj) * max(len(items) - 1, 0) + sum(
            len(x) for x in items if isinstance(x, (str, bytes))
        )
        if total > _MAX_SEQ_LEN:
            raise ConditionBudgetExceeded(
                "condition produced an oversized sequence"
            )
        _charge_alloc(total)
        return obj.join(items)
    return obj.join(*args)


def _g_extend(obj, *args):
    # list.extend consumes a possibly-unbounded iterator in one C call
    if isinstance(obj, list) and len(args) == 1:
        items = list(_capped(args[0]))
        if len(obj) + len(items) > _MAX_ITER_ITEMS:
            raise ConditionBudgetExceeded(
                "condition produced an oversized sequence"
            )
        _charge_alloc(len(items))
        return obj.extend(items)
    return obj.extend(*args)


def _g_update(obj, *args, **kwargs):
    # set.update / dict.update: same single-C-call consumption as extend
    if isinstance(obj, (set, dict)) and len(args) == 1 and not kwargs:
        src = args[0]
        if isinstance(src, dict):
            items = src
        else:
            items = list(_capped(src))
        if len(obj) + len(items) > _MAX_ITER_ITEMS:
            raise ConditionBudgetExceeded(
                "condition produced an oversized collection"
            )
        _charge_alloc(len(items))
        return obj.update(items)
    return obj.update(*args, **kwargs)


def _g_pow(a, b):
    if isinstance(a, int) and isinstance(b, int) and not isinstance(b, bool):
        if a.bit_length() * max(b, 1) > _MAX_INT_BITS:
            raise ConditionBudgetExceeded(
                "condition produced an oversized integer"
            )
    return _guard_int(a ** b)


def _g_lshift(a, b):
    if isinstance(b, int) and b > _MAX_INT_BITS:
        raise ConditionBudgetExceeded("condition produced an oversized integer")
    return _guard_int(a << b)


_GUARDED_BINOPS = {
    ast.Add: "_g_add",
    ast.Mult: "_g_mul",
    ast.Pow: "_g_pow",
    ast.LShift: "_g_lshift",
    ast.Mod: "_g_mod",
}

_GUARDED_METHODS = {
    "replace": "_g_replace",
    "join": "_g_join",
    "extend": "_g_extend",
    "update": "_g_update",
}


class _GuardBinOps(ast.NodeTransformer):
    """Rewrite ``a + b`` / ``a * b`` / ``a ** b`` / ``a << b`` into calls to
    the guarded helpers above, so C-level bignum/sequence blowups are caught
    even though no trace event fires inside them."""

    def visit_BinOp(self, node: ast.BinOp):
        self.generic_visit(node)
        name = _GUARDED_BINOPS.get(type(node.op))
        if name is None:
            return node
        return ast.copy_location(
            ast.Call(
                func=ast.copy_location(ast.Name(id=name, ctx=ast.Load()), node),
                args=[node.left, node.right],
                keywords=[],
            ),
            node,
        )

    def visit_AugAssign(self, node: ast.AugAssign):
        self.generic_visit(node)
        name = _GUARDED_BINOPS.get(type(node.op))
        if name is None or not isinstance(node.target, ast.Name):
            return node
        load = ast.copy_location(
            ast.Name(id=node.target.id, ctx=ast.Load()), node
        )
        call = ast.copy_location(
            ast.Call(
                func=ast.copy_location(ast.Name(id=name, ctx=ast.Load()), node),
                args=[load, node.value],
                keywords=[],
            ),
            node,
        )
        return ast.copy_location(
            ast.Assign(targets=[node.target], value=call), node
        )

    def visit_Call(self, node: ast.Call):
        self.generic_visit(node)
        # route str.replace / str.join through size-checked helpers; calls
        # with keywords are left alone (str forms take none)
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _GUARDED_METHODS
            and not node.keywords
        ):
            return ast.copy_location(
                ast.Call(
                    func=ast.copy_location(
                        ast.Name(
                            id=_GUARDED_METHODS[node.func.attr], ctx=ast.Load()
                        ),
                        node,
                    ),
                    args=[node.func.value, *node.args],
                    keywords=[],
                ),
                node,
            )
        return node


_SAFE_BUILTINS = {
    "len": len,
    "any": _capped_consumer(any),
    "all": _capped_consumer(all),
    "min": _capped_minmax(min),
    "max": _capped_minmax(max),
    "sum": _safe_sum,
    "sorted": _capped_consumer(sorted),
    "str": str,
    "int": int,
    "float": float,
    "bool": bool,
    "list": _capped_consumer(list),
    "dict": _capped_dict,
    "set": _capped_consumer(set),
    "tuple": _capped_consumer(tuple),
    "enumerate": enumerate,
    "zip": zip,
    "range": range,
    "isinstance": isinstance,
    "abs": abs,
    "True": True,
    "False": False,
    "None": None,
}

_ALLOWED_STATEMENTS = (
    ast.Expr,
    ast.Assign,
    ast.AugAssign,
    ast.AnnAssign,
    ast.Return,
    ast.If,
    ast.For,
    ast.While,
    ast.Break,
    ast.Continue,
    ast.Pass,
    ast.FunctionDef,
)

_BANNED_CALL_NAMES = {
    "eval", "exec", "compile", "__import__", "open", "getattr", "setattr",
    "delattr", "globals", "locals", "vars", "breakpoint", "input", "type",
    "object", "super", "memoryview", "bytearray", "classmethod",
    "staticmethod", "property",
}


class ConditionValidationError(ValueError):
    code = 500


class _SafeRegex:
    """Bool-returning regex helpers for conditions.  The raw ``re`` module
    (or Match objects, whose ``.re`` attribute leads back to module
    globals) must never enter the condition namespace."""

    @staticmethod
    def search(pattern: str, string: str) -> bool:
        return re.search(pattern, string) is not None

    @staticmethod
    def match(pattern: str, string: str) -> bool:
        return re.match(pattern, string) is not None

    @staticmethod
    def fullmatch(pattern: str, string: str) -> bool:
        return re.fullmatch(pattern, string) is not None


def _validate_condition_ast(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            raise ConditionValidationError("imports are not allowed in conditions")
        if isinstance(node, (ast.Global, ast.Nonlocal, ast.ClassDef,
                             ast.AsyncFunctionDef, ast.Await, ast.Yield,
                             ast.YieldFrom, ast.Try, ast.Raise, ast.With,
                             ast.AsyncWith, ast.AsyncFor, ast.Delete)):
            raise ConditionValidationError(
                f"{type(node).__name__} is not allowed in conditions"
            )
        if isinstance(node, ast.stmt) and not isinstance(node, _ALLOWED_STATEMENTS):
            raise ConditionValidationError(
                f"statement {type(node).__name__} is not allowed in conditions"
            )
        if isinstance(node, ast.Attribute) and node.attr in (
            # str.format traverses dunder attribute chains at runtime
            # ("{0.__class__...}"), bypassing the static dunder ban
            "format",
            "format_map",
            # single-C-call allocators that can build multi-GB strings the
            # trace budget never sees
            "zfill",
            "center",
            "ljust",
            "rjust",
            "expandtabs",
        ):
            raise ConditionValidationError(
                f"calling {node.attr!r} is not allowed in conditions"
            )
        if (
            isinstance(node, ast.Attribute)
            and node.attr.startswith("_")
            # _queryResult is the documented context-query graft point
            # (reference: accessController.ts:959-965)
            and node.attr != "_queryResult"
        ):
            raise ConditionValidationError(
                f"access to {node.attr!r} is not allowed in conditions"
            )
        if isinstance(node, ast.Name) and node.id.startswith("__"):
            raise ConditionValidationError(
                f"name {node.id!r} is not allowed in conditions"
            )
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id in _BANNED_CALL_NAMES:
                raise ConditionValidationError(
                    f"calling {fn.id!r} is not allowed in conditions"
                )
        if (
            isinstance(node, ast.AugAssign)
            and type(node.op) in _GUARDED_BINOPS
            and not isinstance(node.target, ast.Name)
        ):
            # only Name targets are rewritten through the guarded helpers;
            # 's[0] += s[0]' would bypass the growth checks
            raise ConditionValidationError(
                "augmented assignment to containers is not allowed in "
                "conditions; use the expanded 'x = x + y' form"
            )
        if isinstance(node, ast.FormattedValue) and node.format_spec is not None:
            # f-string format specs pad in a single C call the trace budget
            # never sees ("f'{1:>99999999999}'")
            for part in ast.walk(node.format_spec):
                if isinstance(part, ast.FormattedValue):
                    raise ConditionValidationError(
                        "dynamic format specs are not allowed in conditions"
                    )
                if (
                    isinstance(part, ast.Constant)
                    and isinstance(part.value, str)
                    and _WIDE_FORMAT.search(part.value)
                ):
                    raise ConditionValidationError(
                        "oversized format width is not allowed in conditions"
                    )


class _ExecutionBudget:
    """Caps the traced line/call events of a condition evaluation so a
    hostile/broken condition (``while True``, generator-fed loops) cannot
    hang the PDP; C-level work invisible to the tracer is bounded separately
    by the guarded binops and capped consumer builtins above.  The engine
    converts the raised error into deny-by-default."""

    def __init__(self, max_events: int):
        self.remaining = max_events
        self._previous = None

    def _trace(self, frame, event, arg):
        if event in ("line", "call"):
            self.remaining -= 1
            if self.remaining <= 0:
                raise ConditionBudgetExceeded(
                    "condition exceeded its execution budget"
                )
        return self._trace

    def __enter__(self):
        import sys

        self._previous = sys.gettrace()
        sys.settrace(self._trace)
        return self

    def __exit__(self, *exc):
        import sys

        sys.settrace(self._previous)
        return False


CONDITION_MAX_EVENTS = 200_000


# syntax only JavaScript can be: arrow functions, JS logical/strict
# operators, declaration keywords.  Python conditions containing these
# inside STRING literals would misroute — documented limitation of the
# migration shim (docs/MIGRATING_CONDITIONS.md).
_JS_MARKERS = re.compile(
    r"=>|&&|\|\||===|!==|\btypeof\s|\b(?:let|const|var)\s+[A-Za-z_$]"
)


def condition_matches(condition: str, request) -> bool:
    """Evaluate ``condition`` for ``request``; truthy result means the rule's
    condition holds.  May raise on malformed conditions / contexts.

    Conditions are written in the sandboxed Python subset below; REFERENCE
    policies carrying JavaScript conditions (the reference evals raw JS,
    src/core/utils.ts:47-56) run unmodified through the JS-subset
    interpreter (core/js_conditions.py) — detected by JS-only syntax
    markers or by failing to parse as Python."""

    condition = condition.replace("\\n", "\n")
    if _JS_MARKERS.search(condition):
        from .js_conditions import evaluate_js_condition

        return evaluate_js_condition(condition, request)
    target = request.target
    context = request.context
    # a single namespace (globals) so comprehension/generator scopes inside
    # the evaluated expression still see request/target/context
    env = {
        "__builtins__": dict(_SAFE_BUILTINS),
        "request": request,
        "target": target,
        "context": _wrap(context) if isinstance(context, (dict, list)) else context,
        "re": _SafeRegex,
        "_g_add": _g_add,
        "_g_mul": _g_mul,
        "_g_pow": _g_pow,
        "_g_lshift": _g_lshift,
        "_g_mod": _g_mod,
        "_g_replace": _g_replace,
        "_g_join": _g_join,
        "_g_extend": _g_extend,
        "_g_update": _g_update,
    }

    try:
        tree = ast.parse(condition, mode="eval")
        is_expression = True
    except SyntaxError:
        try:
            tree = ast.parse(condition, mode="exec")
            is_expression = False
        except SyntaxError:
            # not Python at all: the JS migration path
            from .js_conditions import evaluate_js_condition

            return evaluate_js_condition(condition, request)
    _validate_condition_ast(tree)
    tree = ast.fix_missing_locations(_GuardBinOps().visit(tree))

    _ALLOC_STATE.remaining = _MAX_TOTAL_ALLOC
    try:
        with _ExecutionBudget(CONDITION_MAX_EVENTS):
            if is_expression:
                result = eval(compile(tree, "<condition>", "eval"), env)
            else:
                exec(compile(tree, "<condition>", "exec"), env)
                check = env.get("check")
                if not callable(check):
                    raise ConditionValidationError(
                        "multi-line condition must define "
                        "check(request, target, context)"
                    )
                return bool(check(request, env["target"], env["context"]))

            if callable(result):
                return bool(result(request, env["target"], env["context"]))
        return bool(result)
    finally:
        _ALLOC_STATE.remaining = None
