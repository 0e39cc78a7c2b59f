"""Lambda IR grammar - recursive-descent port of the reference's nom
parser (/root/reference/src/ocaml/parser/syntax.rs:23-270).

The IR is an s-expression dialect printed by `ocamlc -dlambda`:
identifiers carry `/NNN` disambiguation suffixes, `!` module markers and
`*match*` pattern names; `[tag: ...]` records; `'c'`/"str" literals with
escapes; and a fixed set of specially-parsed primitives (setglobal, seq,
makeblock, let, letrec, function, apply) with everything else falling
back to opaque FallbackPrimitive/FallbackLiteral nodes - exactly the
reference's recovery strategy for IR forms it does not model.
"""

from __future__ import annotations

from .syntax import LambdaSyntax


class LambdaParseError(Exception):
    def __init__(self, msg: str, pos: int, text: str):
        line = text.count("\n", 0, pos) + 1
        col = pos - (text.rfind("\n", 0, pos) + 1) + 1
        super().__init__(f"{msg} at line {line}, col {col}")
        self.pos = pos


_IDENT_START = set("abcdefghijklmnopqrstuvwxyz"
                   "ABCDEFGHIJKLMNOPQRSTUVWXYZ*")
_IDENT_CONT = _IDENT_START | set("0123456789_'/!")
_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "b": "\b", "\\": "\\",
            '"': '"', "'": "'", " ": " "}


class _P:
    def __init__(self, text: str):
        self.text = text
        self.i = 0

    # -- low-level ---------------------------------------------------------

    def err(self, msg):
        raise LambdaParseError(msg, self.i, self.text)

    def eof(self) -> bool:
        return self.i >= len(self.text)

    def peek(self) -> str:
        return self.text[self.i] if self.i < len(self.text) else ""

    def ws0(self):
        while not self.eof() and self.text[self.i].isspace():
            self.i += 1

    def ws1(self):
        if self.eof() or not self.text[self.i].isspace():
            self.err("expected whitespace")
        self.ws0()

    def lit(self, s: str) -> bool:
        if self.text.startswith(s, self.i):
            self.i += len(s)
            return True
        return False

    def expect(self, s: str):
        if not self.lit(s):
            self.err(f"expected {s!r}")

    # -- tokens (syntax.rs:23-131) -----------------------------------------

    def at_fallback_sep(self) -> bool:
        """peek_for_fallback: '(' ')' or whitespace ends a bare token."""
        c = self.peek()
        return c == "" or c in "()" or c.isspace()

    def ident(self) -> LambdaSyntax:
        c = self.peek()
        if c not in _IDENT_START:
            self.err("expected identifier")
        start = self.i
        self.i += 1
        while self.peek() in _IDENT_CONT:
            self.i += 1
        return LambdaSyntax.ident(self.text[start:self.i])

    def numeric(self) -> LambdaSyntax:
        # int first; floats detected by a '.', 'e' or 'E' continuation
        start = self.i
        neg = self.lit("-")
        d0 = self.i
        while self.peek().isdigit():
            self.i += 1
        if self.i == d0:
            self.err("expected digits")
        nxt = self.peek()
        if nxt and nxt in ".eE":
            self.i = start
            return self._float()
        return LambdaSyntax.int(neg, int(self.text[d0:self.i]))

    def _float(self) -> LambdaSyntax:
        start = self.i
        self.lit("-")
        while self.peek().isdigit():
            self.i += 1
        if self.lit("."):
            while self.peek().isdigit():
                self.i += 1
        if self.peek() in "eE":
            self.i += 1
            self.lit("-") or self.lit("+")
            while self.peek().isdigit():
                self.i += 1
        try:
            return LambdaSyntax.float(float(self.text[start:self.i]))
        except ValueError:
            # e.g. "12e" with no exponent digits: a parse error (so the
            # caller's fallback-literal recovery applies), not a crash
            self.err(f"malformed float {self.text[start:self.i]!r}")

    def _escaped(self, delim: str) -> str:
        c = self.text[self.i]
        self.i += 1
        if c != "\\":
            return c
        if self.eof():
            self.err("unterminated escape")
        e = self.text[self.i]
        self.i += 1
        if e in _ESCAPES:
            return _ESCAPES[e]
        if e == delim:
            return delim
        self.err(f"invalid escape \\{e}")

    def string(self) -> LambdaSyntax:
        self.expect('"')
        out = []
        while not self.eof() and self.peek() != '"':
            out.append(self._escaped('"'))
        self.expect('"')
        return LambdaSyntax.string("".join(out))

    def char(self) -> LambdaSyntax:
        self.expect("'")
        if self.eof():
            self.err("unterminated char")
        c = self._escaped("'")
        self.expect("'")
        return LambdaSyntax.char(c)

    def record(self) -> LambdaSyntax:
        self.expect("[")
        d0 = self.i
        while self.peek().isdigit():
            self.i += 1
        if self.i == d0:
            self.err("expected record tag digits")
        tag = int(self.text[d0:self.i])
        self.expect(":")
        xs = []
        self.ws0()
        while self.peek() != "]":
            xs.append(self.syntax())
            self.ws0()
        self.expect("]")
        return LambdaSyntax.record(tag, xs)

    def fallback_literal(self) -> LambdaSyntax:
        start = self.i
        while not self.at_fallback_sep():
            self.i += 1
        if self.i == start:
            self.err("invalid fallback literal")
        return LambdaSyntax.fallback_literal(self.text[start:self.i])

    # -- s-expressions (syntax.rs:150-270) -----------------------------------

    def _head(self) -> str:
        start = self.i
        while not self.at_fallback_sep():
            self.i += 1
        if self.i == start:
            self.err("invalid head of S-expression")
        return self.text[start:self.i]

    def _let_binding(self):
        self.ws0()
        var = self.ident()
        self.ws1()
        self.fallback_literal()  # the '=' / '=a' / '=*' binder marker
        self.ws0()
        val = self.syntax()
        return (var, val)

    def _letrec_binding(self):
        self.ws0()
        var = self.ident()
        self.ws0()
        val = self.syntax()
        return (var, val)

    def _function_arg(self):
        self.ws0()
        arg = self.ident()
        self.lit("[int]")  # consume and ignore type annotations
        return arg

    def _bindings(self, binder) -> list:
        self.ws1()
        self.expect("(")
        binds = [binder()]
        while True:
            save = self.i
            try:
                binds.append(binder())
            except LambdaParseError:
                self.i = save
                break
        self.expect(")")
        return binds

    def sexp(self) -> LambdaSyntax:
        self.expect("(")
        head = self._head()
        if head == "setglobal":
            self.ws1()
            ident = self.ident()
            self.ws1()
            val = self.syntax()
            self.ws0()
            self.expect(")")
            return LambdaSyntax.setglobal(ident, val)
        if head == "seq":
            xs = [self.syntax()]
            self.ws0()
            while self.peek() != ")":
                xs.append(self.syntax())
                self.ws0()
            self.expect(")")
            return LambdaSyntax.seq(xs)
        if head == "makeblock":
            self.ws1()
            d0 = self.i
            while self.peek().isdigit():
                self.i += 1
            if self.i == d0:
                self.err("expected makeblock tag")
            tag = int(self.text[d0:self.i])
            xs = []
            self.ws0()
            while self.peek() != ")":
                xs.append(self.syntax())
                self.ws0()
            self.expect(")")
            return LambdaSyntax.makeblock(tag, xs)
        if head in ("let", "letrec"):
            binder = self._let_binding if head == "let" \
                else self._letrec_binding
            binds = self._bindings(binder)
            self.ws0()
            body = self.syntax()
            self.ws0()
            self.expect(")")
            ctor = LambdaSyntax.let if head == "let" else LambdaSyntax.letrec
            return ctor(binds, body)
        if head == "function":
            args = []
            while True:
                save = self.i
                try:
                    args.append(self._function_arg())
                except LambdaParseError:
                    self.i = save
                    break
            # optional ': int' return annotation before the body
            save = self.i
            self.ws1() if not self.eof() else None
            if not self.lit(": int"):
                self.i = save
                self.ws0()
            body = self.syntax()
            self.ws0()
            self.expect(")")
            return LambdaSyntax.function(args, body)
        if head == "apply":
            self.ws1()
            func = self.syntax()
            args = [self.syntax()]
            self.ws0()
            while self.peek() != ")":
                args.append(self.syntax())
                self.ws0()
            self.expect(")")
            return LambdaSyntax.apply(func, args)
        # fallback s-expression: mixed syntax / bare literals
        tail = []
        self.ws0()
        while self.peek() != ")":
            save = self.i
            try:
                tail.append(self.syntax())
            except LambdaParseError:
                self.i = save
                self.ws0()
                tail.append(self.fallback_literal())
            self.ws0()
        self.expect(")")
        return LambdaSyntax.fallback_primitive(head, tail)

    def syntax(self) -> LambdaSyntax:
        self.ws0()
        c = self.peek()
        if c == "(":
            out = self.sexp()
        elif c in _IDENT_START:
            out = self.ident()
        elif c == '"':
            out = self.string()
        elif c == "'":
            out = self.char()
        elif c == "[":
            out = self.record()
        elif c == "-" or c.isdigit():
            out = self.numeric()
        else:
            self.err("expected syntax")
        self.ws0()
        return out


def parse_syntax(text: str) -> LambdaSyntax:
    """Parse one Lambda IR expression; the whole input must be consumed
    (mirrors the reference's `assert!(rest.is_empty())`)."""
    p = _P(text)
    out = p.syntax()
    p.ws0()
    if not p.eof():
        p.err("trailing input after Lambda IR expression")
    return out
