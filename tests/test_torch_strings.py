"""The port's string expressions (`expr/strings.py`) and regular
expressions (`expr/regex.py`) against the JAX package on the CPU.

The same seeded strings (multi-byte UTF-8, nulls, empty strings) go
through the JAX engine and the port on device="cpu". Each string function
is held to the JAX engine's host run (its numpy kernels are the same
definitions as its device ones) and, together in one projection, to its
device run; RLIKE and LIKE are held to Python `re` and to the JAX
`match_plan` run by numpy on the same byte matrix. Patterns the JAX
transpiler refuses, and `spark.rapids.sql.regexp.enabled=false`, give the
same tag reason after `!` in both engines' explain. Every comparison is
exact."""

import re

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu.expr import regex as JR
from spark_rapids_tpu.plan.overrides import Overrides as JaxOverrides
from spark_rapids_tpu.plugin import TpuSession as JaxSession
from spark_rapids_tpu.config import TpuConf as JaxConf

import spark_rapids_tpu_torch.expr as PE
from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.expr import regex as PR
from spark_rapids_tpu_torch.plan.overrides import Overrides
from spark_rapids_tpu_torch.plugin import TpuSession

BASE = {"spark.rapids.sql.explain": "NONE"}
ALPHABET = list("abcxyz Q_%.") + ["é", "中", "😀", "\n"]


def _strings(n, seed, max_len=12):
    rng = np.random.default_rng(seed)
    out = ["".join(rng.choice(ALPHABET, rng.integers(0, max_len)))
           for _ in range(n)]
    for i in rng.choice(n, n // 8, replace=False):
        out[i] = None
    out[:6] = ["Spark SQL", "", "  padded  ", "é中😀", "abc", "   "]
    return out


def _table(n=96, seed=0):
    rng = np.random.default_rng(seed + 1)
    s = _strings(n, seed)
    p = [None if v is None or rng.random() < 0.1 else
         v[:rng.integers(0, 3)] if rng.random() < 0.5 else
         "".join(rng.choice(ALPHABET, rng.integers(0, 3)))
         for v in s]
    return pa.table({
        "i": pa.array(np.arange(n), pa.int64()),
        "s": pa.array(s, pa.string()),
        "p": pa.array(p, pa.string()),
        "pos": pa.array(rng.integers(-12, 12, n).astype(np.int32)),
        "len": pa.array(rng.integers(-2, 10, n).astype(np.int32)),
    })


def _cases(m):
    c, lit = m.col, m.lit
    return {
        "length": lambda: m.Length(c("s")),
        "upper": lambda: m.Upper(c("s")),
        "lower": lambda: m.Lower(m.Upper(c("s"))),
        "substr_1_3": lambda: m.Substring(c("s"), lit(1), lit(3)),
        "substr_neg": lambda: m.Substring(c("s"), lit(-3), lit(2)),
        "substr_zero": lambda: m.Substring(c("s"), lit(0), lit(4)),
        "substr_before_start": lambda: m.Substring(c("s"), lit(-10),
                                                   lit(5)),
        "substr_zero_len": lambda: m.Substring(c("s"), lit(5), lit(0)),
        "substr_columns": lambda: m.Substring(c("s"), c("pos"), c("len")),
        "concat2": lambda: m.Concat(c("s"), c("p")),
        "concat3": lambda: m.Concat(c("s"), lit("/"), c("p")),
        "startswith_lit": lambda: m.StartsWith(c("s"), lit("ab")),
        "startswith_col": lambda: m.StartsWith(c("s"), c("p")),
        "endswith_lit": lambda: m.EndsWith(c("s"), lit("😀")),
        "endswith_col": lambda: m.EndsWith(c("s"), c("p")),
        "contains_lit": lambda: m.Contains(c("s"), lit("a ")),
        "contains_empty": lambda: m.Contains(c("s"), lit("")),
        "contains_col": lambda: m.Contains(c("s"), c("p")),
        "trim": lambda: m.StringTrim(c("s")),
        "ltrim": lambda: m.StringTrimLeft(c("s")),
        "rtrim": lambda: m.StringTrimRight(c("s")),
    }


CASES = list(_cases(PE))


def _select(sess, m, names, t):
    cases = _cases(m)
    return sess.from_arrow(t).select(
        "i", **{n: cases[n]() for n in names}).collect().sort_by("i")


@pytest.mark.parametrize("case", CASES)
def test_expression_equals_jax(case):
    """One function over the seeded strings: the port on the device plan
    and on the host engine equal the JAX engine's host run."""
    t = _table(seed=CASES.index(case))
    want = JaxSession(BASE).from_arrow(t).select(
        "i", o=_cases(JE)[case]()).collect_cpu().sort_by("i")
    sess = TpuSession(BASE, device="cpu")
    df = sess.from_arrow(t).select("i", o=_cases(PE)[case]())
    assert df.collect().sort_by("i").equals(want)
    assert df.collect_cpu().sort_by("i").equals(want)


def test_all_functions_equal_jax_device_run():
    """Every function in one projection, against the JAX device path."""
    t = _table(n=64, seed=42)
    want = _select(JaxSession(BASE), JE, CASES, t)
    assert _select(TpuSession(BASE, device="cpu"), PE, CASES, t).equals(want)


def test_spark_examples():
    """Spark's documented answers: 1-based characters, a window that
    begins before the string is shortened, not shifted."""
    t = pa.table({"s": ["Spark SQL", "é中😀x", None]})
    c, lit = PE.col, PE.lit
    got = TpuSession(BASE, device="cpu").from_arrow(t).select(
        a=PE.Substring(c("s"), lit(-10), lit(5)),
        b=PE.Substring(c("s"), lit(2), lit(2)),
        n=PE.Length(c("s")), u=PE.Upper(c("s"))).collect()
    assert got.column("a").to_pylist() == ["Spar", "", None]
    assert got.column("b").to_pylist() == ["pa", "中😀", None]
    assert got.column("n").to_pylist() == [9, 4, None]
    assert got.column("u").to_pylist() == ["SPARK SQL", "é中😀X", None]


# --- regular expressions ---------------------------------------------------

SUBJECTS = [
    "", "a", "b", "ab", "ba", "aab", "abb", "aabb", "abc", "abcabc",
    "hello world", "  spaces  ", "123", "a1b2c3", "999-4444", "12-3456",
    "foo@bar.com", "not an email", "2023-01-15", "99/12/31",
    "aaaaaaaaab", "xyzzy", "line1\nline2", "tab\there", "CAPS", "MiXeD",
    "a.b", "a*b", "[bracket]", "(paren)", "x" * 60, "ab" * 25, "end\n",
    None,
]

PATTERNS = [
    "abc", "^abc", "abc$", "^abc$", "^$", "a", "[abc]", "[^abc]", "[a-z]+",
    "[A-Z]", "[0-9]{3}", "[a-zA-Z0-9]+", r"\d+", r"\D+", r"\w+", r"\W",
    r"\s", r"\S+", "a*b", "a+b", "a?b", "ab{2}", "a{2,}b", "a{1,3}b",
    "colou?r", "x{0,2}y", "a.c", "a.*c", "^.+$", "...", "abc|xyz",
    "^(foo|bar)$", "(ab){1,3}c", "(a|b)c", "a(b|c)d", "(?:ab|cd){1,2}e",
    r"a\.b", r"\(paren\)", r"\d{3}-\d{4}", r"\d{2}/\d{2}/\d{2}",
    r"[\d\s]+", r"\x61+", "a+?b", "a*?b", "d$", r"b\Z", "^[a-c]b",
]

LIKES = ["ab%", "%b", "a_c", "%", "", "_", "%a%b%", "a\\%b", "a\\_%",
         "%.%", "line1%", "%\n%", "x%x", "%@%.com", "(paren)", "[%]%"]


def _subject_bytes():
    b = batch_from_arrow(pa.table({"s": pa.array(SUBJECTS, pa.string())}),
                         "cpu")
    c = b.columns[0]
    return c.data, c.lengths, c.validity


@pytest.mark.parametrize("pattern", PATTERNS)
def test_rlike_vs_re_and_jax_machine(pattern):
    """The port's machine equals Python re.search and the JAX machine on
    the same bytes, row for row."""
    chars, lens, valid = _subject_bytes()
    assert PR.device_supported_pattern(pattern) is None
    got = PR.match_plan(PR.compile_device_plan(pattern), chars, lens)
    jax = JR.match_plan(np, JR.compile_device_plan(pattern),
                        chars.numpy(), lens.numpy())
    rx = re.compile(pattern)
    for i, s in enumerate(SUBJECTS):
        if s is not None:
            assert bool(got[i]) == bool(rx.search(s)), (pattern, s)
    assert (got.numpy() == np.asarray(jax)).all()


@pytest.mark.parametrize("pattern", LIKES)
def test_like_vs_re_and_jax(pattern):
    """LIKE on the device plan and the host engine against a fullmatch of
    the translated regex (DOTALL) and the JAX engine's device run."""
    t = pa.table({"s": pa.array(SUBJECTS, pa.string())})
    rx = re.compile(PR.like_pattern_to_regex(pattern), re.DOTALL)
    assert PR.like_pattern_to_regex(pattern) == \
        JR.like_pattern_to_regex(pattern)
    want = [None if s is None else bool(rx.fullmatch(s)) for s in SUBJECTS]
    df = TpuSession(BASE, device="cpu").from_arrow(t).select(
        m=PE.Like(PE.col("s"), PE.lit(pattern)))
    assert df.collect().column("m").to_pylist() == want
    assert df.collect_cpu().column("m").to_pylist() == want
    chars, lens, _ = _subject_bytes()
    jplan = JR.Like(JE.col("s"), JE.lit(pattern))._plan
    jm = JR.match_plan(np, jplan, chars.numpy(), lens.numpy())
    assert [None if s is None else bool(x)
            for s, x in zip(SUBJECTS, jm)] == want


def test_like_copies_the_shared_plan():
    """Like widens `.` in a copy: the cached plan RLike reads is
    untouched, so two expressions over one regex never alias."""
    PE.Like(PE.col("s"), PE.lit("a_c"))
    rl = PE.RLike(PE.col("s"), PE.lit("^a.c$"))
    t = pa.table({"s": ["a\nc", "abc"]})
    b = batch_from_arrow(t, "cpu").columns[0]
    assert PR.match_plan(rl._plan, b.data, b.lengths)[:2].tolist() == \
        [False, True]
    lk = PE.Like(PE.col("s"), PE.lit("a_c"))
    assert PR.match_plan(lk._plan, b.data, b.lengths)[:2].tolist() == \
        [True, True]


def _explain(conf, plan_of):
    """The `!` lines of both engines' explain for one query."""
    conf = dict(conf, **{"spark.rapids.sql.explain": "NOT_ON_GPU"})
    t = pa.table({"s": pa.array(SUBJECTS, pa.string())})
    jov = JaxOverrides(JaxConf(conf))
    jov.apply(plan_of(JaxSession(conf), JE, t).plan)
    pov = Overrides(TpuConf(conf), torch.device("cpu"))
    pov.apply(plan_of(TpuSession(conf, device="cpu"), PE, t).plan)
    return ([ln.strip() for ln in jov.explain_string().splitlines()
             if "!" in ln],
            [ln.strip() for ln in pov.explain_string().splitlines()
             if "!" in ln])


REFUSED = [r"\bword\b", "(?=a)b", r"(a)\1", "(ab)+c", "a++",
           "é+", "(a|b|c|d|e){1,3}"]


@pytest.mark.parametrize("pattern", REFUSED)
def test_refused_pattern_tags_like_jax(pattern):
    """A pattern the transpiler refuses: the same `!` reason in both
    explains, and the rows of Python re on the host engine."""
    def q(sess, m, t):
        return sess.from_arrow(t).select(
            r=m.RLike(m.col("s"), m.lit(pattern)))

    jl, pl = _explain(BASE, q)
    assert pl and pl == jl
    assert "pattern is not supported on TPU" in pl[0]
    t = pa.table({"s": pa.array(SUBJECTS, pa.string())})
    rx = re.compile(pattern)
    got = q(TpuSession(BASE, device="cpu"), PE, t).collect()
    assert got.column("r").to_pylist() == \
        [None if s is None else bool(rx.search(s)) for s in SUBJECTS]


def test_regexp_disabled_tags_like_jax():
    def q(sess, m, t):
        return sess.from_arrow(t).filter(m.Like(m.col("s"), m.lit("ab%")))

    conf = dict(BASE, **{"spark.rapids.sql.regexp.enabled": False})
    jl, pl = _explain(conf, q)
    assert pl == jl
    assert "regular expressions are disabled via " \
        "spark.rapids.sql.regexp.enabled" in pl[0]
    t = pa.table({"s": pa.array(SUBJECTS, pa.string())})
    got = q(TpuSession(conf, device="cpu"), PE, t).collect()
    assert got.column("s").to_pylist() == ["ab", "abb", "abc", "abcabc",
                                           "ab" * 25]


@pytest.mark.parametrize("kind", ["replace", "extract", "extract0"])
def test_host_only_regex_equals_jax(kind):
    """RegExpReplace and RegExpExtract run on the host engine (their JAX
    tag in both explains) and equal the JAX engine's rows."""
    def q(sess, m, t):
        e = {"replace": lambda: m.RegExpReplace(
                 m.col("s"), m.lit(r"(\d+)-(\d+)"), m.lit("$2:$1")),
             "extract": lambda: m.RegExpExtract(
                 m.col("s"), m.lit(r"([a-z]+)@([a-z]+)"), 2),
             "extract0": lambda: m.RegExpExtract(
                 m.col("s"), m.lit(r"b+"), 0)}[kind]()
        return sess.from_arrow(t).select(o=e)

    jl, pl = _explain(BASE, q)
    assert pl == jl and "runs on CPU" in pl[0]
    t = pa.table({"s": pa.array(SUBJECTS, pa.string())})
    want = q(JaxSession(BASE), JE, t).collect()
    assert q(TpuSession(BASE, device="cpu"), PE, t).collect().equals(want)


def test_upper_incompat_tag():
    """Upper and Lower are incompat (ASCII only): with incompatible ops
    off they tag in both engines."""
    def q(sess, m, t):
        return sess.from_arrow(t).select(u=m.Upper(m.col("s")))

    jl, pl = _explain({"spark.rapids.sql.incompatibleOps.enabled": False},
                      q)
    assert pl == jl and "incompat" in pl[0]
