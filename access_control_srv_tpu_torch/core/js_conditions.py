"""JavaScript-subset interpreter for reference policy conditions.

The reference evaluates rule conditions as raw JavaScript via ``eval``
(reference: src/core/utils.ts:47-56; fixtures
test/fixtures/conditions.yml, context_query.yml).  This framework's
native condition language is the sandboxed Python of
``core/conditions.py`` — a deliberate redesign — but existing
restorecommerce policy corpora carry JS conditions, so this module lets
them run UNMODIFIED: ``core.conditions.condition_matches`` falls back
here when a condition does not parse as Python.

This is an interpreter for the JS subset that policy conditions
actually use (statements: let/const/var, if/else, return, expression;
expressions: literals, template-free strings, identifiers, member
access, calls, arrow functions, array/object literals, the standard
operators, ternary) — NOT a full ECMAScript engine.  Deliberate
semantics matches with JS where policy behavior depends on them:

- ``null`` and ``undefined`` both map to Python ``None`` (so
  ``x == null`` covers both, like JS loose equality);
- missing object properties read as ``undefined`` (None); property
  access ON ``null``/``undefined`` RAISES, exactly like the JS
  TypeError the reference turns into an immediate DENY
  (accessController.ts:259-270);
- JS truthiness: empty arrays/objects are truthy (unlike Python);
- ``==``/``!=`` do limited string/number coercion; ``===``/``!==``
  are strict;
- the program result is the completion value of the last evaluated
  statement, like the reference's ``eval``.

Execution is budgeted (op count + recursion depth) like the Python
sandbox; there is no access to anything beyond the provided
request/target/context bindings and the whitelisted methods below.
"""

from __future__ import annotations

import re as _re
from typing import Any, Optional


class JsConditionError(ValueError):
    """Parse or runtime failure; the engine maps it to DENY + code,
    mirroring the reference's thrown-condition handling."""


_MAX_OPS = 200_000
_MAX_DEPTH = 64

_TOKEN_RE = _re.compile(r"""
    (?P<ws>\s+|//[^\n]*|/\*.*?\*/)
  | (?P<num>\d+(?:\.\d+)?)
  | (?P<str>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
  | (?P<name>[A-Za-z_$][A-Za-z0-9_$]*)
  | (?P<punct>=>|===|!==|==|!=|<=|>=|&&|\|\||[-+*/%!<>=(){}\[\];,.?:])
""", _re.VERBOSE | _re.DOTALL)

_KEYWORDS = {"let", "const", "var", "if", "else", "return", "true",
             "false", "null", "undefined", "typeof", "function"}


def _tokenize(src: str) -> list[tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise JsConditionError(
                f"unexpected character {src[pos]!r} at offset {pos}"
            )
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        text = m.group()
        kind = m.lastgroup
        if kind == "name" and text in _KEYWORDS:
            kind = "kw"
        out.append((kind, text))
    out.append(("eof", ""))
    return out


# ------------------------------------------------------------------ parser
# AST nodes are plain tuples: (kind, ...)

class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self, k=0):
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self):
        tok = self.toks[self.i]
        self.i += 1
        return tok

    def expect(self, text):
        kind, tok = self.next()
        if tok != text:
            raise JsConditionError(f"expected {text!r}, got {tok!r}")

    def at(self, text):
        return self.peek()[1] == text and self.peek()[0] != "str"

    def eat(self, text):
        if self.at(text):
            self.next()
            return True
        return False

    # statements ----------------------------------------------------------
    def program(self):
        stmts = []
        while self.peek()[0] != "eof":
            stmts.append(self.statement())
        return ("block", stmts)

    def statement(self):
        kind, tok = self.peek()
        if kind == "kw" and tok in ("let", "const", "var"):
            self.next()
            _, name = self.next()
            init = None
            if self.eat("="):
                init = self.expression()
            self.eat(";")
            return ("decl", name, init)
        if kind == "kw" and tok == "if":
            self.next()
            self.expect("(")
            cond = self.expression()
            self.expect(")")
            then = self.block_or_stmt()
            other = None
            if self.peek() == ("kw", "else"):
                self.next()
                other = self.block_or_stmt()
            return ("if", cond, then, other)
        if kind == "kw" and tok == "return":
            self.next()
            value = None
            if not (self.at(";") or self.at("}") or self.peek()[0] == "eof"):
                value = self.expression()
            self.eat(";")
            return ("return", value)
        expr = self.expression()
        self.eat(";")
        return ("expr", expr)

    def block_or_stmt(self):
        if self.eat("{"):
            stmts = []
            while not self.eat("}"):
                if self.peek()[0] == "eof":
                    raise JsConditionError("unterminated block")
                stmts.append(self.statement())
            return ("block", stmts)
        return self.statement()

    # expressions ---------------------------------------------------------
    def expression(self):
        return self.assignment()

    def assignment(self):
        # lookahead: Name '=' (not '==' / '=>')
        if (
            self.peek()[0] == "name"
            and self.peek(1)[1] == "="
            and self.peek(1)[0] == "punct"
        ):
            _, name = self.next()
            self.next()  # '='
            return ("assign", name, self.assignment())
        return self.ternary()

    def ternary(self):
        cond = self.logic_or()
        if self.eat("?"):
            then = self.assignment()
            self.expect(":")
            other = self.assignment()
            return ("ternary", cond, then, other)
        return cond

    def logic_or(self):
        node = self.logic_and()
        while self.eat("||"):
            node = ("or", node, self.logic_and())
        return node

    def logic_and(self):
        node = self.equality()
        while self.eat("&&"):
            node = ("and", node, self.equality())
        return node

    def equality(self):
        node = self.relational()
        while self.peek()[1] in ("==", "!=", "===", "!==") and \
                self.peek()[0] == "punct":
            _, op = self.next()
            node = ("binop", op, node, self.relational())
        return node

    def relational(self):
        node = self.additive()
        while self.peek()[1] in ("<", ">", "<=", ">=") and \
                self.peek()[0] == "punct":
            _, op = self.next()
            node = ("binop", op, node, self.additive())
        return node

    def additive(self):
        node = self.multiplicative()
        while self.peek()[1] in ("+", "-") and self.peek()[0] == "punct":
            _, op = self.next()
            node = ("binop", op, node, self.multiplicative())
        return node

    def multiplicative(self):
        node = self.unary()
        while self.peek()[1] in ("*", "/", "%") and self.peek()[0] == "punct":
            _, op = self.next()
            node = ("binop", op, node, self.unary())
        return node

    def unary(self):
        if self.eat("!"):
            return ("not", self.unary())
        if self.eat("-"):
            return ("neg", self.unary())
        if self.peek() == ("kw", "typeof"):
            self.next()
            return ("typeof", self.unary())
        return self.postfix()

    def postfix(self):
        node = self.primary()
        while True:
            if self.eat("."):
                _, name = self.next()
                node = ("member", node, name)
            elif self.eat("["):
                index = self.expression()
                self.expect("]")
                node = ("index", node, index)
            elif self.at("("):
                self.next()
                args = []
                if not self.at(")"):
                    args.append(self.assignment())
                    while self.eat(","):
                        args.append(self.assignment())
                self.expect(")")
                node = ("call", node, args)
            else:
                return node

    def _try_arrow(self):
        """Lookahead for '(' params ')' '=>' or Name '=>'."""
        if self.peek()[0] == "name" and self.peek(1)[1] == "=>":
            _, name = self.next()
            self.next()  # '=>'
            return self._arrow_body([name])
        if not self.at("("):
            return None
        # scan ahead: ( Name (, Name)* ) =>
        j = self.i + 1
        params = []
        while self.toks[j][0] == "name":
            params.append(self.toks[j][1])
            j += 1
            if self.toks[j][1] == ",":
                j += 1
            else:
                break
        if self.toks[j][1] != ")" or self.toks[j + 1][1] != "=>":
            if not (self.toks[self.i + 1][1] == ")"
                    and self.toks[self.i + 2][1] == "=>"):
                return None
            params = []
            j = self.i + 1
        self.i = j + 2  # past ') =>'
        return self._arrow_body(params)

    def _arrow_body(self, params):
        if self.at("{"):
            body = self.block_or_stmt()
            return ("arrow", params, body, True)
        return ("arrow", params, self.assignment(), False)

    def primary(self):
        arrow = self._try_arrow()
        if arrow is not None:
            return arrow
        kind, tok = self.next()
        if kind == "num":
            return ("lit", float(tok) if "." in tok else int(tok))
        if kind == "str":
            body = tok[1:-1]
            return ("lit", _re.sub(r"\\(.)", r"\1", body))
        if kind == "kw":
            if tok == "true":
                return ("lit", True)
            if tok == "false":
                return ("lit", False)
            if tok in ("null", "undefined"):
                return ("lit", None)
            raise JsConditionError(f"unsupported keyword {tok!r}")
        if kind == "name":
            return ("var", tok)
        if tok == "(":
            node = self.expression()
            self.expect(")")
            return node
        if tok == "[":
            items = []
            if not self.at("]"):
                items.append(self.assignment())
                while self.eat(","):
                    if self.at("]"):
                        break
                    items.append(self.assignment())
            self.expect("]")
            return ("array", items)
        if tok == "{":
            pairs = []
            if not self.at("}"):
                while True:
                    k_kind, key = self.next()
                    if k_kind == "str":
                        key = key[1:-1]
                    self.expect(":")
                    pairs.append((key, self.assignment()))
                    if not self.eat(","):
                        break
            self.expect("}")
            return ("object", pairs)
        raise JsConditionError(f"unexpected token {tok!r}")


# --------------------------------------------------------------- evaluator

class _Return(Exception):
    def __init__(self, value):
        self.value = value


_UNSET = object()


class _Budget:
    __slots__ = ("ops",)

    def __init__(self):
        self.ops = _MAX_OPS

    def charge(self):
        self.ops -= 1
        if self.ops <= 0:
            raise JsConditionError("condition execution budget exceeded")


def _truthy(v) -> bool:
    """JS truthiness: arrays/objects are always truthy."""
    if isinstance(v, (list, dict)):
        return True
    if isinstance(v, float) and v != v:  # NaN
        return False
    return bool(v)


def _strict_eq(a, b) -> bool:
    """JS === / SameValueZero: one number type (1 === 1.0 is true),
    booleans are not numbers."""
    if isinstance(a, bool) or isinstance(b, bool):
        return isinstance(a, bool) and isinstance(b, bool) and a == b
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a == b
    return type(a) is type(b) and a == b


def _loose_eq(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, bool) or isinstance(b, bool):
        return _truthy(a) == _truthy(b) if isinstance(a, bool) and \
            isinstance(b, bool) else _loose_eq(
                1 if a is True else 0 if a is False else a,
                1 if b is True else 0 if b is False else b)
    if isinstance(a, str) and isinstance(b, (int, float)):
        try:
            return float(a) == b
        except ValueError:
            return False
    if isinstance(b, str) and isinstance(a, (int, float)):
        return _loose_eq(b, a)
    return a == b


def _member(obj, name, budget):
    budget.charge()
    if obj is None:
        raise JsConditionError(
            f"cannot read property {name!r} of null/undefined"
        )
    if isinstance(obj, dict):
        return obj.get(name, None)
    if isinstance(obj, (list, str)) and name == "length":
        return len(obj)
    if isinstance(obj, (list, str)):
        method = _METHODS.get((type(obj) is str and "str" or "list", name))
        if method is not None:
            return _Bound(method, obj)
        return None
    # model objects (request/target/attributes) expose their DATA fields
    # only: underscore-prefixed names are rejected (the same boundary the
    # Python sandbox enforces — '__init__.__globals__' style traversal
    # must not escape through the JS path) and Python callables are
    # invisible (JS conditions have no business invoking model methods)
    if name.startswith("_"):
        raise JsConditionError(
            f"access to {name!r} is not allowed in conditions"
        )
    if hasattr(obj, name):
        value = getattr(obj, name)
        if callable(value):
            return None
        return value
    return None


class _Bound:
    __slots__ = ("fn", "this")

    def __init__(self, fn, this):
        self.fn = fn
        self.this = this


def _call_fn(fn, args, budget):
    budget.charge()
    if isinstance(fn, _Bound):
        return fn.fn(fn.this, args, budget)
    if callable(fn):  # arrow closure
        return fn(args)
    raise JsConditionError("value is not callable")


def _cb(args, budget):
    if not args or not callable(args[0]):
        raise JsConditionError("expected a function argument")
    fn = args[0]

    def run(*xs):
        budget.charge()
        return fn(list(xs))

    return run


def _needle(args) -> str:
    return "undefined" if not args or args[0] is None else str(args[0])


_METHODS = {
    ("list", "find"): lambda this, a, b: next(
        (x for x in this if _truthy(_cb(a, b)(x))), None),
    ("list", "filter"): lambda this, a, b: [
        x for x in this if _truthy(_cb(a, b)(x))],
    ("list", "map"): lambda this, a, b: [_cb(a, b)(x) for x in this],
    ("list", "some"): lambda this, a, b: any(
        _truthy(_cb(a, b)(x)) for x in this),
    ("list", "every"): lambda this, a, b: all(
        _truthy(_cb(a, b)(x)) for x in this),
    ("list", "includes"): lambda this, a, b: any(
        _strict_eq(x, a[0] if a else None) for x in this),
    ("list", "indexOf"): lambda this, a, b: next(
        (i for i, x in enumerate(this)
         if _strict_eq(x, a[0] if a else None)), -1),
    ("list", "concat"): lambda this, a, b: this + [
        y for x in a for y in (x if isinstance(x, list) else [x])],
    ("list", "slice"): lambda this, a, b: this[
        int(a[0]) if a else 0: int(a[1]) if len(a) > 1 else None],
    ("list", "join"): lambda this, a, b: (
        a[0] if a else ",").join(str(x) for x in this),
    # JS string-coerces a missing/undefined needle to "undefined"
    ("str", "includes"): lambda this, a, b: _needle(a) in this,
    ("str", "startsWith"): lambda this, a, b: this.startswith(_needle(a)),
    ("str", "endsWith"): lambda this, a, b: this.endswith(_needle(a)),
    ("str", "toLowerCase"): lambda this, a, b: this.lower(),
    ("str", "toUpperCase"): lambda this, a, b: this.upper(),
    ("str", "indexOf"): lambda this, a, b: this.find(a[0] if a else ""),
    ("str", "split"): lambda this, a, b: this.split(a[0]) if a else [this],
    ("str", "trim"): lambda this, a, b: this.strip(),
    ("str", "slice"): lambda this, a, b: this[
        int(a[0]) if a else 0: int(a[1]) if len(a) > 1 else None],
}


class _Interp:
    def __init__(self, env: dict, budget: _Budget):
        self.scopes = [env]
        self.budget = budget
        self.depth = 0
        self.completion = None

    def lookup(self, name):
        for scope in reversed(self.scopes):
            if name in scope:
                return scope[name]
        raise JsConditionError(f"{name!r} is not defined")

    def assign(self, name, value):
        for scope in reversed(self.scopes):
            if name in scope:
                scope[name] = value
                return
        self.scopes[-1][name] = value

    def run_stmt(self, node):
        self.budget.charge()
        kind = node[0]
        if kind == "block":
            for stmt in node[1]:
                self.run_stmt(stmt)
            return
        if kind == "decl":
            value = self.eval(node[2]) if node[2] is not None else None
            self.scopes[-1][node[1]] = value
            return
        if kind == "if":
            if _truthy(self.eval(node[1])):
                self.run_stmt(node[2])
            elif node[3] is not None:
                self.run_stmt(node[3])
            return
        if kind == "return":
            raise _Return(self.eval(node[1]) if node[1] is not None else None)
        if kind == "expr":
            self.completion = self.eval(node[1])
            return
        raise JsConditionError(f"unsupported statement {kind!r}")

    def eval(self, node):
        self.budget.charge()
        kind = node[0]
        if kind == "lit":
            return node[1]
        if kind == "var":
            return self.lookup(node[1])
        if kind == "assign":
            value = self.eval(node[2])
            self.assign(node[1], value)
            return value
        if kind == "member":
            return _member(self.eval(node[1]), node[2], self.budget)
        if kind == "index":
            obj = self.eval(node[1])
            idx = self.eval(node[2])
            if obj is None:
                raise JsConditionError("cannot index null/undefined")
            if isinstance(obj, dict):
                return obj.get(idx)
            if isinstance(obj, (list, str)):
                i = int(idx)
                return obj[i] if -len(obj) <= i < len(obj) else None
            return None
        if kind == "call":
            callee = node[1]
            if callee[0] == "member":
                obj = self.eval(callee[1])
                fn = _member(obj, callee[2], self.budget)
                if fn is None:
                    raise JsConditionError(
                        f"{callee[2]!r} is not a function"
                    )
            else:
                fn = self.eval(callee)
            args = [self.eval(a) for a in node[2]]
            return _call_fn(fn, args, self.budget)
        if kind == "arrow":
            params, body, is_block = node[1], node[2], node[3]
            outer = list(self.scopes)

            def closure(args):
                if self.depth >= _MAX_DEPTH:
                    raise JsConditionError("condition recursion too deep")
                saved = self.scopes
                self.scopes = outer + [dict(zip(params, args))]
                self.depth += 1
                try:
                    if is_block:
                        try:
                            self.run_stmt(body)
                            return None  # no return -> undefined
                        except _Return as ret:
                            return ret.value
                    return self.eval(body)
                finally:
                    self.depth -= 1
                    self.scopes = saved

            return closure
        if kind == "and":
            left = self.eval(node[1])
            return self.eval(node[2]) if _truthy(left) else left
        if kind == "or":
            left = self.eval(node[1])
            return left if _truthy(left) else self.eval(node[2])
        if kind == "not":
            return not _truthy(self.eval(node[1]))
        if kind == "neg":
            return -self.eval(node[1])
        if kind == "typeof":
            try:
                value = self.eval(node[1])
            except JsConditionError:
                return "undefined"
            if value is None:
                return "undefined"  # typeof null is 'object' in JS, but
                # conditions use typeof x == 'undefined' guards
            if isinstance(value, bool):
                return "boolean"
            if isinstance(value, (int, float)):
                return "number"
            if isinstance(value, str):
                return "string"
            if callable(value) or isinstance(value, _Bound):
                return "function"
            return "object"
        if kind == "ternary":
            return (self.eval(node[2]) if _truthy(self.eval(node[1]))
                    else self.eval(node[3]))
        if kind == "binop":
            op = node[1]
            a = self.eval(node[2])
            b = self.eval(node[3])
            if op == "==":
                return _loose_eq(a, b)
            if op == "!=":
                return not _loose_eq(a, b)
            if op == "===":
                return _strict_eq(a, b)
            if op == "!==":
                return not _strict_eq(a, b)
            if op == "+":
                if isinstance(a, str) or isinstance(b, str):
                    return f"{'' if a is None else a}" \
                           f"{'' if b is None else b}"
                return (a or 0) + (b or 0)
            try:
                if op == "-":
                    return a - b
                if op == "*":
                    return a * b
                if op == "/":
                    return a / b if b else float("nan")
                if op == "%":
                    return a % b
                if op == "<":
                    return a < b
                if op == ">":
                    return a > b
                if op == "<=":
                    return a <= b
                if op == ">=":
                    return a >= b
            except TypeError as err:
                raise JsConditionError(str(err)) from None
        if kind == "array":
            return [self.eval(x) for x in node[1]]
        if kind == "object":
            return {k: self.eval(v) for k, v in node[1]}
        raise JsConditionError(f"unsupported expression {kind!r}")


_PARSE_CACHE: dict[str, tuple] = {}


def parse_js_condition(condition: str):
    """Parse (cached); raises JsConditionError on unsupported syntax."""
    tree = _PARSE_CACHE.get(condition)
    if tree is None:
        tree = _Parser(_tokenize(condition)).program()
        if len(_PARSE_CACHE) >= 4096:
            _PARSE_CACHE.pop(next(iter(_PARSE_CACHE)))
        _PARSE_CACHE[condition] = tree
    return tree


def evaluate_js_condition(condition: str, request) -> bool:
    """Evaluate a JS condition against the request; the result is the
    completion value of the last statement (the reference's eval
    contract)."""
    tree = parse_js_condition(condition)
    env = {
        "request": request,
        "target": request.target,
        "context": request.context,
        "JSON": {},
    }
    interp = _Interp(env, _Budget())
    try:
        interp.run_stmt(tree)
    except _Return as ret:
        return _truthy(ret.value)
    return _truthy(interp.completion)
