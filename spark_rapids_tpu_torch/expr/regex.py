"""Regular expressions: a Java-regex parser and a transpiler to a
bit-parallel Shift-And machine over the byte matrix
(`spark_rapids_tpu/expr/regex.py`; reference `RegexParser.scala`,
`GpuRegExpReplaceMeta.scala`).

A pattern becomes at most MAX_ALTERNATIVES linear alternatives of at most
MAX_ITEMS items (byte classes, each optional and/or repeating); the whole
column advances one byte a step with bitwise tensor ops, `w` steps of
O(n) work (`match_plan`). The state words are int64 with the JAX
package's uint64 bit layout: bit 0 is the start state and the highest
item bit is 62, so the sign bit is never a live state.

Supported on the device: literals, escapes (\\d \\w \\s \\D \\W \\S \\t \\n
\\r \\xHH and escaped metacharacters), classes with ranges, negation and
predefined classes, `.`, the anchors `^ $ \\A \\z`, the quantifiers
`? * + {m} {m,} {m,n}` (lazy forms accepted), groups expanded by
alternative distribution, and alternation. Anything else raises
RegexUnsupportedError while the expression is built, and the planner
tags the expression with that reason: it runs on the host, through
Python `re`, as RegExpReplace and RegExpExtract always do.

The machine is byte-level: exact for ASCII subjects; over multi-byte
UTF-8, `.` and negated classes match single bytes, so counted quantifiers
can differ from the JVM, and the planner marks RLike and Like incompat.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import numpy as np
import torch

from .. import types as T
from ..columnar.padding import width_bucket
from .base import EvalContext, Expression, Literal, Vec
from .strings import decode_rows, strings_to_vec

__all__ = ["RegexUnsupportedError", "parse_regex", "compile_device_plan",
           "RLike", "Like", "RegExpReplace", "RegExpExtract",
           "device_supported_pattern", "like_pattern_to_regex",
           "match_plan"]


class RegexUnsupportedError(ValueError):
    """Pattern uses a construct the device machine cannot express."""


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RxNode:
    pass


@dataclasses.dataclass
class RxClass(RxNode):
    """A byte class: bool[256] acceptance table."""
    table: np.ndarray  # bool[256]


@dataclasses.dataclass
class RxSeq(RxNode):
    parts: List[RxNode]


@dataclasses.dataclass
class RxAlt(RxNode):
    options: List[RxNode]


@dataclasses.dataclass
class RxRepeat(RxNode):
    child: RxNode
    min_count: int
    max_count: Optional[int]  # None = unbounded


@dataclasses.dataclass
class RxAnchor(RxNode):
    kind: str  # "start" | "end"


# ---------------------------------------------------------------------------
# Parser (Java regex subset; reference RegexParser.scala parses the same
# grammar before transpiling to the cuDF dialect)
# ---------------------------------------------------------------------------


def _class_of(chars: str) -> np.ndarray:
    t = np.zeros(256, dtype=bool)
    for c in chars:
        t[ord(c)] = True
    return t


def _class_range(lo: int, hi: int) -> np.ndarray:
    t = np.zeros(256, dtype=bool)
    t[lo:hi + 1] = True
    return t


_DIGIT = _class_range(ord("0"), ord("9"))
_WORD = _class_range(ord("a"), ord("z")) | _class_range(ord("A"), ord("Z")) \
    | _DIGIT | _class_of("_")
_SPACE = _class_of(" \t\n\x0b\f\r")
# Java '.' matches any char except line terminators; byte-level here
_DOT = ~_class_of("\n\r")


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def error(self, msg: str) -> RegexUnsupportedError:
        return RegexUnsupportedError(
            f"regex {self.p!r} at {self.i}: {msg}")

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def next(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    def parse(self) -> RxNode:
        node = self.parse_alt()
        if self.i != len(self.p):
            raise self.error(f"unexpected {self.p[self.i]!r}")
        return node

    def parse_alt(self) -> RxNode:
        options = [self.parse_seq()]
        while self.peek() == "|":
            self.next()
            options.append(self.parse_seq())
        return options[0] if len(options) == 1 else RxAlt(options)

    def parse_seq(self) -> RxNode:
        parts: List[RxNode] = []
        while True:
            c = self.peek()
            if c is None or c in "|)":
                break
            parts.append(self.parse_quantified())
        return RxSeq(parts)

    def parse_quantified(self) -> RxNode:
        atom = self.parse_atom()
        c = self.peek()
        if c in ("*", "+", "?"):
            self.next()
            if isinstance(atom, RxAnchor):
                raise self.error("quantifier on anchor")
            lo, hi = {"*": (0, None), "+": (1, None), "?": (0, 1)}[c]
            self._eat_lazy()
            return RxRepeat(atom, lo, hi)
        if c == "{":
            save = self.i
            self.next()
            spec = ""
            while self.peek() is not None and self.peek() != "}":
                spec += self.next()
            if self.peek() != "}":
                self.i = save  # Java treats unclosed '{' as literal
                return atom
            self.next()
            import re as _re
            m = _re.fullmatch(r"(\d+)(,(\d*)?)?", spec)
            if not m:
                self.i = save
                return atom
            lo = int(m.group(1))
            hi = lo if m.group(2) is None else (
                int(m.group(3)) if m.group(3) else None)
            if hi is not None and hi < lo:
                raise self.error(f"bad repetition {{{spec}}}")
            if isinstance(atom, RxAnchor):
                raise self.error("quantifier on anchor")
            self._eat_lazy()
            return RxRepeat(atom, lo, hi)
        return atom

    def _eat_lazy(self) -> None:
        # lazy/possessive markers don't change ACCEPTANCE; possessive (*+)
        # does, so reject it
        if self.peek() == "?":
            self.next()
        elif self.peek() == "+":
            raise self.error("possessive quantifiers are not supported")

    def parse_atom(self) -> RxNode:
        c = self.next()
        if c == "(":
            if self.peek() == "?":
                self.next()
                q = self.peek()
                if q == ":":
                    self.next()
                else:
                    raise self.error(
                        "lookaround / inline flags are not supported")
            inner = self.parse_alt()
            if self.peek() != ")":
                raise self.error("unclosed group")
            self.next()
            return inner
        if c == "[":
            return self.parse_class()
        if c == "^":
            return RxAnchor("start")
        if c == "$":
            return RxAnchor("end")
        if c == ".":
            return RxClass(_DOT.copy())
        if c == "\\":
            return self.parse_escape(in_class=False)
        if c in "*+?":
            raise self.error(f"dangling {c!r}")
        # '{' not opening a valid repetition is a literal brace (Java behavior)
        return RxClass(_class_of(c))

    def parse_escape(self, in_class: bool) -> RxNode:
        if self.peek() is None:
            raise self.error("trailing backslash")
        c = self.next()
        simple = {"d": _DIGIT, "D": ~_DIGIT, "w": _WORD, "W": ~_WORD,
                  "s": _SPACE, "S": ~_SPACE}
        if c in simple:
            return RxClass(simple[c].copy())
        if c == "t":
            return RxClass(_class_of("\t"))
        if c == "n":
            return RxClass(_class_of("\n"))
        if c == "r":
            return RxClass(_class_of("\r"))
        if c == "f":
            return RxClass(_class_of("\f"))
        if c == "0":
            return RxClass(_class_of("\0"))
        if c == "x":
            h = ""
            for _ in range(2):
                if self.peek() is None or self.peek() not in \
                        "0123456789abcdefABCDEF":
                    raise self.error("bad \\x escape")
                h += self.next()
            return RxClass(_class_range(int(h, 16), int(h, 16)))
        if c == "A" and not in_class:
            return RxAnchor("start")
        if c in ("z", "Z") and not in_class:
            return RxAnchor("endz")  # absolute end (\Z ~ \z: no terminators)
        if c in "bBG":
            raise self.error(f"\\{c} is not supported")
        if c.isdigit():
            raise self.error("backreferences are not supported")
        if c == "p" or c == "P":
            raise self.error("unicode property classes are not supported")
        if not c.isalnum():
            return RxClass(_class_of(c))  # escaped metachar
        raise self.error(f"unknown escape \\{c}")

    def parse_class(self) -> RxNode:
        negate = False
        if self.peek() == "^":
            self.next()
            negate = True
        table = np.zeros(256, dtype=bool)
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise self.error("unclosed character class")
            if c == "]" and not first:
                self.next()
                break
            first = False
            c = self.next()
            if c == "\\":
                node = self.parse_escape(in_class=True)
                if not isinstance(node, RxClass):
                    raise self.error("bad escape in class")
                sub = node.table
                if self.peek() == "-" and self.i + 1 < len(self.p) and \
                        self.p[self.i + 1] != "]":
                    raise self.error("range from escape class")
                table |= sub
                continue
            lo = ord(c)
            if self.peek() == "-" and self.i + 1 < len(self.p) and \
                    self.p[self.i + 1] != "]":
                self.next()
                hic = self.next()
                if hic == "\\":
                    node = self.parse_escape(in_class=True)
                    raise self.error("range to escape class")
                hi = ord(hic)
                if hi < lo:
                    raise self.error("inverted class range")
                if hi > 255 or lo > 255:
                    raise self.error("non-latin1 class range on device")
                table |= _class_range(lo, hi)
            else:
                if lo > 255:
                    raise self.error("non-latin1 literal in class on device")
                table[lo] = True
        if negate:
            table = ~table
        return RxClass(table)


def parse_regex(pattern: str) -> RxNode:
    for ch in pattern:
        if ord(ch) > 127:
            raise RegexUnsupportedError(
                "non-ASCII pattern characters need byte-sequence expansion")
    return _Parser(pattern).parse()


# ---------------------------------------------------------------------------
# Transpiler: AST -> linear item sequences for the Shift-And machine
# ---------------------------------------------------------------------------

MAX_ITEMS = 62       # +1 start bit must fit a uint64
MAX_ALTERNATIVES = 16


@dataclasses.dataclass
class _Item:
    table: np.ndarray   # bool[256]
    optional: bool = False
    repeat: bool = False


@dataclasses.dataclass
class _LinearAlt:
    items: List[_Item]
    anchored_start: bool = False
    # None = unanchored; "dollar" = $ (end, or before a final \n, Java-style);
    # "abs" = \z/\Z (absolute end; also used by LIKE)
    anchored_end: Optional[str] = None

    @property
    def nullable(self) -> bool:
        return all(i.optional for i in self.items)


@dataclasses.dataclass
class DevicePlan:
    """Compiled device regex: one Shift-And machine per alternative."""
    alternatives: List[_LinearAlt]
    pattern: str


def _distribute(node: RxNode) -> List[List[RxNode]]:
    """Flatten alternation/groups into alternative flat sequences of
    RxClass/RxRepeat(RxClass)/RxAnchor atoms (cross-product expansion)."""
    if isinstance(node, RxClass) or isinstance(node, RxAnchor):
        return [[node]]
    if isinstance(node, RxAlt):
        out: List[List[RxNode]] = []
        for opt in node.options:
            out.extend(_distribute(opt))
            if len(out) > MAX_ALTERNATIVES:
                raise RegexUnsupportedError("too many alternatives")
        return out
    if isinstance(node, RxSeq):
        seqs: List[List[RxNode]] = [[]]
        for part in node.parts:
            subs = _distribute(part)
            seqs = [s + sub for s in seqs for sub in subs]
            if len(seqs) > MAX_ALTERNATIVES:
                raise RegexUnsupportedError("too many alternatives")
        return seqs
    if isinstance(node, RxRepeat):
        child_alts = _distribute(node.child)
        # single-class repeats stay symbolic (self-loop in the machine);
        # rebuild on the DISTRIBUTED class so '(a)+' (group around a class)
        # carries the RxClass child _linearize expects
        if len(child_alts) == 1 and len(child_alts[0]) == 1 and \
                isinstance(child_alts[0][0], RxClass):
            return [[RxRepeat(child_alts[0][0], node.min_count,
                              node.max_count)]]
        # group repeats expand by count (bounded only)
        if node.max_count is None:
            raise RegexUnsupportedError(
                "unbounded repetition of a group is not supported on device")
        if any(isinstance(a, RxAnchor) for alt in child_alts for a in alt):
            raise RegexUnsupportedError("anchor inside a repeated group")
        out = []
        for count in range(node.min_count, node.max_count + 1):
            if count == 0:
                out.append([])
                continue
            pools = [child_alts] * count
            expanded: List[List[RxNode]] = [[]]
            for pool in pools:
                expanded = [e + alt for e in expanded for alt in pool]
                if len(expanded) > MAX_ALTERNATIVES:
                    raise RegexUnsupportedError("group repetition too wide")
            out.extend(expanded)
            if len(out) > MAX_ALTERNATIVES:
                raise RegexUnsupportedError("group repetition too wide")
        return out
    raise RegexUnsupportedError(f"unsupported node {type(node).__name__}")


def _linearize(seq: List[RxNode]) -> _LinearAlt:
    alt = _LinearAlt(items=[])
    for i, node in enumerate(seq):
        if isinstance(node, RxAnchor):
            if node.kind == "start":
                if i != 0:
                    raise RegexUnsupportedError("^ not at pattern start")
                alt.anchored_start = True
            else:
                if i != len(seq) - 1:
                    raise RegexUnsupportedError("$ not at pattern end")
                alt.anchored_end = "dollar" if node.kind == "end" else "abs"
            continue
        if isinstance(node, RxClass):
            alt.items.append(_Item(node.table))
            continue
        assert isinstance(node, RxRepeat) and isinstance(node.child, RxClass)
        t = node.child.table
        lo, hi = node.min_count, node.max_count
        for _ in range(lo):
            alt.items.append(_Item(t))
        if hi is None:
            if lo == 0:
                alt.items.append(_Item(t, optional=True, repeat=True))  # *
            else:
                alt.items[-1] = _Item(t, repeat=True)  # + (last of the run)
        else:
            for _ in range(hi - lo):
                alt.items.append(_Item(t, optional=True))
        if len(alt.items) > MAX_ITEMS:
            raise RegexUnsupportedError("pattern expands past device limit")
    if len(alt.items) > MAX_ITEMS:
        raise RegexUnsupportedError("pattern expands past device limit")
    return alt


@functools.lru_cache(maxsize=256)
def _try_compile(pattern: str):
    """(plan|None, reason|None) — compiled once per pattern per process; every
    consumer (expression init, planner tag) shares this cache so the
    cross-product expansion cost is paid once."""
    try:
        ast = parse_regex(pattern)
        alts = [_linearize(seq) for seq in _distribute(ast)]
        return DevicePlan(alts, pattern), None
    except RegexUnsupportedError as e:
        return None, str(e)


def compile_device_plan(pattern: str) -> DevicePlan:
    plan, reason = _try_compile(pattern)
    if plan is None:
        raise RegexUnsupportedError(reason)
    return plan


def device_supported_pattern(pattern: str) -> Optional[str]:
    """None if the pattern compiles for the device; else the reason string
    (the planner's tag message, like the reference's transpiler check)."""
    return _try_compile(pattern)[1]


# ---------------------------------------------------------------------------
# Device execution: the Shift-And machine over the byte matrix
# ---------------------------------------------------------------------------


def _bit(i: int) -> int:
    return 1 << i


def _machine_masks(alt: _LinearAlt):
    """(class table int64[256], optional mask, repeat mask, m): bit 0 is
    the virtual start, item i bit i + 1."""
    cls = np.zeros(256, dtype=np.int64)
    opt = rep = 0
    for i, item in enumerate(alt.items):
        cls[item.table] |= _bit(i + 1)
        if item.optional:
            opt |= _bit(i + 1)
        if item.repeat:
            rep |= _bit(i + 1)
    return cls, opt, rep, len(alt.items)


def _eclose(D: torch.Tensor, opt: int, max_run: int) -> torch.Tensor:
    """Epsilon closure over optional items: bit i activates bit i + 1
    while item i + 1 is optional (bounded by the longest optional run)."""
    for _ in range(max_run):
        D = D | ((D << 1) & opt)
    return D


def _longest_optional_run(alt: _LinearAlt) -> int:
    run = best = 0
    for item in alt.items:
        run = run + 1 if item.optional else 0
        best = max(best, run)
    return best


def match_plan(plan: DevicePlan, chars: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """bool[n]: does the pattern match each row (java Matcher.find)."""
    n, w = chars.shape
    dev = chars.device
    lengths = lengths.to(torch.int64)
    matched = torch.zeros(n, dtype=torch.bool, device=dev)
    # Java $ also matches just before a final line terminator; byte-level
    # a final \n is honoured (\r and \r\n are a documented divergence)
    last_idx = torch.clamp(lengths - 1, 0, max(w - 1, 0))
    last_byte = torch.gather(chars, 1, last_idx[:, None])[:, 0]
    eff_len = torch.where((lengths > 0) & (last_byte == ord("\n")),
                          lengths - 1, lengths)
    for alt in plan.alternatives:
        def end_ok(pos):
            # may a match end at position pos (0..w)?
            if alt.anchored_end is None:
                return pos <= lengths
            if alt.anchored_end == "abs":
                return lengths == pos
            return (lengths == pos) | (eff_len == pos)

        cls_np, opt, rep, m = _machine_masks(alt)
        if m == 0 or alt.nullable:
            # a zero-length match exists at every position; anchored at
            # both ends it must sit at an allowed start and end
            if alt.anchored_start and alt.anchored_end:
                ok = end_ok(0)
            else:
                ok = torch.ones(n, dtype=torch.bool, device=dev)
            matched = matched | ok
            if m == 0:
                continue
        max_run = _longest_optional_run(alt)
        cls = torch.from_numpy(cls_np).to(dev)
        accept = _bit(m)
        D = torch.zeros(n, dtype=torch.int64, device=dev)
        A = _eclose(torch.ones(n, dtype=torch.int64, device=dev), opt,
                    max_run)
        alt_matched = ((A & accept) != 0) & end_ok(0)
        for j in range(w):
            cj = cls[chars[:, j].to(torch.int64)]
            inject = (not alt.anchored_start) or j == 0
            pre = _eclose(D | 1 if inject else D, opt, max_run)
            consumed = ((pre << 1) & cj) | (D & rep & cj)
            live = j < lengths
            D = torch.where(live, consumed, D)
            A = _eclose(D, opt, max_run)
            alt_matched = alt_matched | (((A & accept) != 0) & live
                                         & end_ok(j + 1))
        matched = matched | alt_matched
    return matched


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


def _pattern_literal(expr: Expression) -> Optional[str]:
    if isinstance(expr, Literal) and isinstance(expr.value, str):
        return expr.value
    return None


def _on_host() -> bool:
    from ..cpu.hostbatch import on_host
    return on_host()


def _bools(values, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.bool).reshape(-1).to(
        like.device)


class RLike(Expression):
    """str RLIKE pattern (java Matcher.find): the Shift-And machine on the
    device, Python `re.search` on the host engine."""

    def __init__(self, child: Expression, pattern: Expression):
        pattern = self._wrap(pattern)
        super().__init__([child, pattern])
        self.pattern = _pattern_literal(pattern)
        self._plan: Optional[DevicePlan] = None
        self.device_reason: Optional[str] = None
        if self.pattern is None:
            self.device_reason = "pattern must be a string literal"
        else:
            self._plan, self.device_reason = _try_compile(self.pattern)

    @property
    def data_type(self):
        return T.BOOLEAN

    def _compute(self, ctx: EvalContext, s: Vec, p: Vec) -> Vec:
        if _on_host():
            import re
            rx = re.compile(self.pattern)
            ok = [bool(rx.search(r)) if r is not None else False
                  for r in decode_rows(s)]
            return Vec(T.BOOLEAN, _bools(ok, s.validity), s.validity)
        if self._plan is None:
            raise RuntimeError(
                f"pattern {self.pattern!r} is not device-compilable "
                "(planner should have kept this on CPU)")
        return Vec(T.BOOLEAN, match_plan(self._plan, s.data, s.lengths),
                   s.validity)

    def __repr__(self):
        return f"RLike({self.children[0]!r}, {self.pattern!r})"


def like_pattern_to_regex(pattern: str, escape: str = "\\") -> str:
    """SQL LIKE -> regex: % is .*, _ is ., the escape char protects both."""
    out = ["^"]
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == escape and i + 1 < len(pattern):
            nxt = pattern[i + 1]
            out.append("\\" + nxt if not nxt.isalnum() else nxt)
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        elif not c.isalnum():
            out.append("\\" + c)
        else:
            out.append(c)
        i += 1
    out.append("$")
    return "".join(out)


class Like(Expression):
    """SQL LIKE: an anchored regex machine whose `.` also crosses line
    terminators. The compiled plan is cached per pattern and shared, so
    LIKE widens a deep copy of it."""

    def __init__(self, child: Expression, pattern: Expression,
                 escape: str = "\\"):
        pattern = self._wrap(pattern)
        super().__init__([child, pattern])
        self.escape = escape
        self.pattern = _pattern_literal(pattern)
        self.regex = None if self.pattern is None else \
            like_pattern_to_regex(self.pattern, escape)
        self._plan: Optional[DevicePlan] = None
        self.device_reason: Optional[str] = None
        if self.regex is None:
            self.device_reason = "pattern must be a string literal"
        else:
            plan, self.device_reason = _try_compile(self.regex)
            if plan is not None:
                import copy
                plan = copy.deepcopy(plan)
                for alt in plan.alternatives:
                    # a whole-string match: absolute end, and '%'/'_' (->
                    # '.') cross line terminators too
                    alt.anchored_end = "abs"
                    for item in alt.items:
                        if (item.table == _DOT).all():
                            item.table[:] = True
                self._plan = plan

    @property
    def data_type(self):
        return T.BOOLEAN

    def _compute(self, ctx: EvalContext, s: Vec, p: Vec) -> Vec:
        if _on_host():
            import re
            # fullmatch: a '$'-anchored match would also take a value with
            # a trailing newline, which SQL LIKE must not
            rx = re.compile(self.regex, re.DOTALL)
            ok = [bool(rx.fullmatch(r)) if r is not None else False
                  for r in decode_rows(s)]
            return Vec(T.BOOLEAN, _bools(ok, s.validity), s.validity)
        if self._plan is None:
            raise RuntimeError(f"LIKE {self.pattern!r} not device-compilable")
        return Vec(T.BOOLEAN, match_plan(self._plan, s.data, s.lengths),
                   s.validity)

    def __repr__(self):
        extra = f", escape={self.escape!r}" if self.escape != "\\" else ""
        return f"Like({self.children[0]!r}, {self.pattern!r}{extra})"


class RegExpReplace(Expression):
    """regexp_replace: Python `re` on the host engine (the planner always
    tags it: the device byte-rewrite kernel is pending)."""

    def __init__(self, child: Expression, pattern: Expression,
                 replacement: Expression):
        pattern, replacement = self._wrap(pattern), self._wrap(replacement)
        super().__init__([child, pattern, replacement])
        self.pattern = _pattern_literal(pattern)
        self.replacement = _pattern_literal(replacement)

    @property
    def data_type(self):
        return T.STRING

    def _compute(self, ctx: EvalContext, s: Vec, p: Vec, r: Vec) -> Vec:
        import re
        # Java group references $1 -> Python \1
        repl = re.sub(r"\$(\d+)", r"\\\1", self.replacement)
        rx = re.compile(self.pattern)
        out = [rx.sub(repl, row) if row is not None else None
               for row in decode_rows(s)]
        return strings_to_vec(out, s.validity)

    def __repr__(self):
        return f"RegExpReplace({self.children[0]!r}, {self.pattern!r})"


def check_group_index(pattern: str, idx: int) -> None:
    """Spark's RegExpExtractBase.checkGroupIndex: an out-of-range group
    index is an error, not an empty result."""
    import re
    groups = re.compile(pattern).groups
    if idx < 0:
        raise ValueError(
            "The specified group index cannot be less than zero")
    if idx > groups:
        raise ValueError(
            f"Regex group count is {groups}, but the specified group "
            f"index is {idx}")


class RegExpExtract(Expression):
    """regexp_extract(str, pattern, idx): Python `re` on the host engine;
    '' where nothing matches, as in Spark."""

    def __init__(self, child: Expression, pattern: Expression,
                 idx: int = 1):
        pattern = self._wrap(pattern)
        super().__init__([child, pattern])
        self.pattern = _pattern_literal(pattern)
        self.idx = idx
        check_group_index(self.pattern, self.idx)

    @property
    def data_type(self):
        return T.STRING

    def _compute(self, ctx: EvalContext, s: Vec, p: Vec) -> Vec:
        import re
        rx = re.compile(self.pattern)
        out = []
        for row in decode_rows(s):
            if row is None:
                out.append(None)
                continue
            m = rx.search(row)
            g = None if m is None else m.group(self.idx)
            out.append(g if g is not None else "")
        return strings_to_vec(out, s.validity)

    def __repr__(self):
        return f"RegExpExtract({self.children[0]!r}, {self.pattern!r}, " \
               f"{self.idx})"
