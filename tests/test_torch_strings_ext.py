"""The port's strings_ext and strings_more functions against the JAX
package on the CPU.

The same seeded strings (multi-byte UTF-8, empty strings, nulls) go
through the JAX engine's host run (its numpy kernels are the definitions
its device runs) and the port on device="cpu", on the device plan and on
the host engine. Every function of the two JAX modules is held there
exactly. The forms the JAX planner tags to the host (a non-literal size,
pad, separator or pattern; a non-ASCII pad or translate argument) print
the JAX reason in both engines' explain; on the host the port computes
Spark's rule, held to a Python oracle of it (the JAX CPU engine returns
another value there, or fails: ROADMAP.md Queue C). A long string makes
every function rerun the plan on the host (`CpuFallbackRequired`), with
the same answer."""

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.expr as JE
from spark_rapids_tpu.config import TpuConf as JaxConf
from spark_rapids_tpu.plan.overrides import Overrides as JaxOverrides
from spark_rapids_tpu.plugin import TpuSession as JaxSession

import spark_rapids_tpu_torch.expr as PE
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.errors import CpuFallbackRequired
from spark_rapids_tpu_torch.expr import strings_ext as PX
from spark_rapids_tpu_torch.plan.overrides import Overrides
from spark_rapids_tpu_torch.plugin import TpuSession
from spark_rapids_tpu_torch.utils.metrics import TaskMetrics

BASE = {"spark.rapids.sql.explain": "NONE"}
ALPHABET = list("abcxyz aA,-") + ["é", "中", "😀"]
NAMES = ["Robert", "Rupert", "Rubin", "Ashcraft", "Tymczak", "Pfister",
         "honeyman", "Lee", "", "1abc", "Gutierrez", "Jackson"]


def _strings(rng, n, max_len=10):
    out = ["".join(rng.choice(ALPHABET, rng.integers(0, max_len)))
           for _ in range(n)]
    for i in rng.choice(n, n // 8, replace=False):
        out[i] = None
    return out


def _table(n=64, seed=0):
    rng = np.random.default_rng(seed)
    s = _strings(rng, n)
    s[:6] = ["Spark SQL", "", "a,b,,a", "é中😀", "aaaa", "hello world"]
    p = [None if rng.random() < 0.1 else
         "".join(rng.choice(ALPHABET, rng.integers(0, 3))) for _ in range(n)]
    lst = [None if rng.random() < 0.1 else
           ",".join("".join(rng.choice(ALPHABET[:6], rng.integers(0, 3)))
                    for _ in range(rng.integers(0, 4))) for _ in range(n)]
    x = rng.normal(0, 1e6, n) * rng.choice([1e-6, 1e-2, 1, 1e3], n)
    x[:5] = [0.125, -2.675, 1e19, np.nan, 999.995]
    num = ["".join(rng.choice(list("0123456789abcdefXZ"),
                              rng.integers(0, 9))) for _ in range(n)]
    return pa.table({
        "i": pa.array(np.arange(n), pa.int64()),
        "s": pa.array(s, pa.string()),
        "p": pa.array(p, pa.string()),
        "lst": pa.array(lst, pa.string()),
        "name": pa.array([NAMES[k % len(NAMES)] if k % 9 else None
                          for k in range(n)], pa.string()),
        "n": pa.array(rng.integers(-5, 300, n).astype(np.int32)),
        "len": pa.array(rng.integers(-2, 8, n).astype(np.int32)),
        "x": pa.array(np.where(rng.random(n) < 0.1, np.nan, x)),
        "num": pa.array(num, pa.string()),
    })


def _cases(m):
    c, lit = m.col, m.lit
    return {
        "repeat": lambda: m.StringRepeat(c("s"), lit(3)),
        "repeat_zero": lambda: m.StringRepeat(c("s"), lit(0)),
        "lpad": lambda: m.StringLPad(c("s"), lit(6), lit("xy")),
        "lpad_space": lambda: m.StringLPad(c("s"), lit(4)),
        "rpad": lambda: m.StringRPad(c("s"), lit(7), lit("-")),
        "locate": lambda: m.StringLocate(c("p"), c("s")),
        "locate_start": lambda: m.StringLocate(lit("a"), c("s"), lit(2)),
        "instr": lambda: m.StringInstr(c("s"), lit("中")),
        "replace": lambda: m.StringReplace(c("s"), lit("a"), lit("XYZ")),
        "replace_delete": lambda: m.StringReplace(c("s"), lit("中")),
        "translate": lambda: m.StringTranslate(c("s"), lit("abca"),
                                               lit("xy")),
        "reverse": lambda: m.StringReverse(c("s")),
        "concat_ws": lambda: m.ConcatWs(lit("/"), c("s"), c("p"), lit("z")),
        "substring_index": lambda: m.SubstringIndex(c("s"), lit("a"),
                                                    lit(2)),
        "substring_index_neg": lambda: m.SubstringIndex(c("s"), lit(","),
                                                        lit(-1)),
        "initcap": lambda: m.InitCap(c("s")),
        "ascii": lambda: m.Ascii(c("s")),
        "chr": lambda: m.Chr(c("n")),
        "left": lambda: m.Left(c("s"), lit(3)),
        "left_column": lambda: m.Left(c("s"), c("len")),
        "right": lambda: m.Right(c("s"), lit(2)),
        "space": lambda: m.StringSpace(lit(3)),
        "bit_length": lambda: m.BitLength(c("s")),
        "octet_length": lambda: m.OctetLength(c("s")),
        "find_in_set": lambda: m.FindInSet(c("p"), c("lst")),
        "overlay": lambda: m.Overlay(c("s"), lit("AB"), lit(2)),
        "overlay_len": lambda: m.Overlay(c("s"), c("p"), lit(3), lit(1)),
        "levenshtein": lambda: m.Levenshtein(c("s"), c("p")),
        "soundex": lambda: m.SoundEx(c("name")),
        "empty2null": lambda: m.Empty2Null(c("s")),
        "format_number": lambda: m.FormatNumber(c("x"), lit(2)),
        "format_number_0": lambda: m.FormatNumber(c("n"), lit(0)),
        "conv": lambda: m.Conv(c("num"), lit(16), lit(2)),
        "conv_36": lambda: m.Conv(c("num"), lit(36), lit(10)),
    }


CASES = list(_cases(PE))
# the functions that read a string input (the long-string gate applies)
STRING_INPUT = [k for k in CASES if k not in ("chr", "space",
                                              "format_number",
                                              "format_number_0")]


@pytest.mark.parametrize("case", CASES)
def test_expression_equals_jax(case):
    """One function over the seeded strings: the port's device plan and
    host engine equal the JAX engine's host run."""
    t = _table(seed=CASES.index(case))
    want = JaxSession(BASE).from_arrow(t).select(
        "i", o=_cases(JE)[case]()).collect_cpu().sort_by("i")
    sess = TpuSession(BASE, device="cpu")
    df = sess.from_arrow(t).select("i", o=_cases(PE)[case]())
    assert df.collect().sort_by("i").equals(want)
    assert df.collect_cpu().sort_by("i").equals(want)


def _levenshtein(a, b):
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a):
        cur = [i + 1]
        for j, cb in enumerate(b):
            cur.append(min(prev[j + 1] + 1, cur[j] + 1,
                           prev[j] + (ca != cb)))
        prev = cur
    return prev[-1]


def test_spark_examples():
    """Spark's documented answers."""
    t = pa.table({"s": ["hi", "SparkSql", "a.b.c", None]})
    c, lit = PE.col, PE.lit
    got = TpuSession(BASE, device="cpu").from_arrow(t).select(
        lp=PE.StringLPad(c("s"), lit(5), lit("??")),
        rp=PE.StringRPad(c("s"), lit(1), lit("?")),
        ix=PE.SubstringIndex(c("s"), lit("."), lit(2)),
        tr=PE.StringTranslate(c("s"), lit("Sq"), lit("s")),
        ic=PE.InitCap(PE.Concat(c("s"), lit(" iN"))),
        lv=PE.Levenshtein(c("s"), lit("kitten")),
        sx=PE.SoundEx(lit("Miller"))).collect()
    assert got.column("lp").to_pylist() == ["???hi", "Spark", "a.b.c",
                                            None]
    assert got.column("rp").to_pylist() == ["h", "S", "a", None]
    assert got.column("ix").to_pylist() == ["hi", "SparkSql", "a.b", None]
    assert got.column("tr").to_pylist() == ["hi", "sparksl", "a.b.c", None]
    assert got.column("ic").to_pylist() == ["Hi In", "Sparksql In",
                                            "A.b.c In", None]
    assert got.column("lv").to_pylist() == [_levenshtein(v, "kitten")
                                            for v in ("hi", "SparkSql",
                                                      "a.b.c")] + [None]
    assert got.column("sx").to_pylist() == ["M460"] * 4


# --- the forms the JAX planner tags to the host ---------------------------

def _spark_pad(s, n, pad, left):
    if n <= len(s) or not pad:
        return s[:max(n, 0)]
    fill = (pad * n)[:n - len(s)]
    return fill + s if left else s + fill


def _spark_translate(s, frm, to):
    table = {}
    for i, ch in enumerate(frm):
        table.setdefault(ch, to[i] if i < len(to) else "")
    return "".join(table.get(ch, ch) for ch in s)


def _nn(f):
    return lambda *a: None if any(x is None for x in a) else f(*a)


TAGGED = {
    # name: (the expression in namespace m, the JAX tag's reason, the
    # columns it reads, an oracle of Spark's rule over their values)
    "repeat_column": (
        lambda m: m.StringRepeat(m.col("s"), m.col("k")),
        "StringRepeat requires a literal repeat count on TPU (static "
        "output width)", "sk", _nn(lambda s, k: s * max(k, 0))),
    "lpad_length_column": (
        lambda m: m.StringLPad(m.col("s"), m.col("k"), m.lit("*")),
        "lpad/rpad requires a literal length on TPU", "sk",
        _nn(lambda s, k: _spark_pad(s, k, "*", True))),
    "rpad_pad_column": (
        lambda m: m.StringRPad(m.col("s"), m.lit(6), m.col("p")),
        "lpad/rpad requires a literal pad string on TPU", "sp",
        _nn(lambda s, p: _spark_pad(s, 6, p, False))),
    "lpad_non_ascii": (
        lambda m: m.StringLPad(m.col("s"), m.lit(5), m.lit("é中")),
        "non-ASCII pad strings are not supported on TPU", "s",
        _nn(lambda s: _spark_pad(s, 5, "é中", True))),
    "translate_column": (
        lambda m: m.StringTranslate(m.col("s"), m.col("p"), m.lit("Z")),
        "translate requires literal from/to strings on TPU", "sp",
        _nn(lambda s, p: _spark_translate(s, p, "Z"))),
    "translate_non_ascii": (
        lambda m: m.StringTranslate(m.col("s"), m.lit("é中a"),
                                    m.lit("e")),
        "non-ASCII translate arguments are not supported on TPU", "s",
        _nn(lambda s: _spark_translate(s, "é中a", "e"))),
    "replace_column": (
        lambda m: m.StringReplace(m.col("s"), m.col("p"), m.lit("_")),
        "replace requires literal search/replacement strings on TPU", "sp",
        _nn(lambda s, p: s.replace(p, "_") if p else s)),
    "concat_ws_column": (
        lambda m: m.ConcatWs(m.col("p"), m.col("s"), m.lit("z")),
        "ConcatWs requires a literal separator on TPU (static output "
        "width)", "sp",
        lambda s, p: None if p is None else
        p.join(x for x in (s, "z") if x is not None)),
    "substring_index_column": (
        lambda m: m.SubstringIndex(m.col("s"), m.lit("a"), m.col("k")),
        "substring_index requires literal delimiter/count on TPU", "sk",
        _nn(lambda s, k: "" if k == 0 else "a".join(
            s.split("a")[:k] if k > 0 else s.split("a")[k:]))),
    "space_column": (
        lambda m: m.StringSpace(m.col("k")),
        "StringSpace requires a literal count on TPU (static output "
        "width)", "k", _nn(lambda k: " " * max(k, 0))),
}


def _tagged_table(n=40, seed=5):
    rng = np.random.default_rng(seed)
    s = _strings(rng, n)
    s[:3] = ["abcab", "", "é中x"]
    p = [None if rng.random() < 0.1 else
         "".join(rng.choice(ALPHABET, rng.integers(0, 3))) for _ in range(n)]
    k = [None if rng.random() < 0.1 else int(v)
         for v in rng.integers(-2, 7, n)]
    return pa.table({"i": pa.array(np.arange(n), pa.int64()),
                     "s": pa.array(s, pa.string()),
                     "p": pa.array(p, pa.string()),
                     "k": pa.array(k, pa.int32())})


@pytest.mark.parametrize("case", list(TAGGED))
def test_tagged_form_runs_on_the_host(case):
    """The JAX tag and its reason in explain, in both engines; the port's
    host run equals an oracle of Spark's rule."""
    make, reason, reads, oracle = TAGGED[case]
    t = _tagged_table()
    df = TpuSession(BASE, device="cpu").from_arrow(t).select(
        "i", o=make(PE))
    rows = zip(*(t.column(n).to_pylist() for n in reads))
    want = [oracle(*r) for r in rows]
    assert df.collect().sort_by("i").column("o").to_pylist() == want
    assert df.collect_cpu().sort_by("i").column("o").to_pylist() == want
    conf = dict(BASE, **{"spark.rapids.sql.explain": "NOT_ON_GPU"})
    jov = JaxOverrides(JaxConf(conf))
    jov.apply(JaxSession(conf).from_arrow(t).select("i", o=make(JE)).plan)
    pov = Overrides(TpuConf(conf), torch.device("cpu"))
    pov.apply(TpuSession(conf, device="cpu").from_arrow(t).select(
        "i", o=make(PE)).plan)
    want = [ln.strip() for ln in jov.explain_string().splitlines()
            if "!" in ln]
    assert [ln.strip() for ln in pov.explain_string().splitlines()
            if "!" in ln] == want
    assert any(reason in ln for ln in want)


def test_host_path_refuses_a_device_tensor():
    """A tagged form never runs off the host: its row path raises on a
    tensor that does not lie on the CPU (a planner fault), where the
    literal form computes."""
    from spark_rapids_tpu_torch.expr.base import EvalContext, Vec
    from spark_rapids_tpu_torch import types as T
    meta = Vec(T.STRING, torch.zeros((4, 8), dtype=torch.uint8,
                                     device="meta"),
               torch.ones(4, dtype=torch.bool, device="meta"),
               torch.zeros(4, dtype=torch.int32, device="meta"))
    k = Vec(T.INT, torch.ones(4, dtype=torch.int32, device="meta"),
            torch.ones(4, dtype=torch.bool, device="meta"))
    ctx = EvalContext(torch.ones(4, dtype=torch.bool, device="meta"))
    tagged = PX.StringRepeat(PE.col("s"), PE.col("k"))
    assert tagged.device_reason() is not None
    with pytest.raises(RuntimeError, match="host engine only"):
        tagged._compute(ctx, meta, k)
    literal = PX.StringRepeat(PE.col("s"), PE.lit(2))
    assert literal.device_reason() is None
    assert literal._compute(ctx, meta, k).data.shape == (4, 16)


# --- the long-string layout -------------------------------------------------

LONG = "z" * 300 + "é,a"


@pytest.mark.parametrize("case", STRING_INPUT)
def test_long_string_reruns_on_the_host(case):
    """A value past the head width raises CpuFallbackRequired at the
    function (as JAX `Expression.eval` does), the session reruns the plan
    on the host, and the answer equals the JAX engine's host run."""
    t = _table(n=24, seed=100 + CASES.index(case))
    cols = {n: t.column(n).to_pylist() for n in ("s", "p", "name", "num")}
    for n in cols:
        cols[n][2] = LONG
    t = t.drop(list(cols)).append_column("s", pa.array(cols["s"])) \
        .append_column("p", pa.array(cols["p"])) \
        .append_column("name", pa.array(cols["name"])) \
        .append_column("num", pa.array(cols["num"]))
    want = JaxSession(BASE).from_arrow(t).select(
        "i", o=_cases(JE)[case]()).collect_cpu().sort_by("i")
    sess = TpuSession(BASE, device="cpu")
    df = sess.from_arrow(t).select("i", o=_cases(PE)[case]())
    with pytest.raises(CpuFallbackRequired):
        list(sess.plan_device(df.plan).execute())
    got = df.collect().sort_by("i")
    assert TaskMetrics.get().cpu_fallback_reruns == 1
    assert got.equals(want)


def test_format_number_over_decimal_refused():
    """The JAX kernel formats a decimal's unscaled value (1.50 as '150.00'):
    the port refuses format_number over a decimal at plan time."""
    import decimal
    t = pa.table({"d": pa.array([decimal.Decimal("1.50")],
                                pa.decimal128(3, 2))})
    q = TpuSession(BASE, device="cpu").from_arrow(t).select(
        o=PE.FormatNumber(PE.col("d"), PE.lit(2)))
    with pytest.raises(NotImplementedError, match="format_number"):
        q.explain()
    assert JaxSession(BASE).from_arrow(t).select(
        o=JE.FormatNumber(JE.col("d"), JE.lit(2))).collect_cpu() \
        .column("o").to_pylist() == ["150.00"]


@pytest.mark.parametrize("conf", [{}, {
    "spark.rapids.sql.incompatibleOps.enabled": False}],
    ids=["default", "incompat_off"])
@pytest.mark.parametrize("case", CASES)
def test_explain_matches_jax(case, conf):
    """Every rule's tags and `!` reasons equal the JAX planner's: none on
    the literal forms; initcap's incompat tag when incompatible ops are
    off."""
    t = _table(n=8)
    conf = dict(BASE, **conf, **{"spark.rapids.sql.explain": "NOT_ON_GPU"})
    jov = JaxOverrides(JaxConf(conf))
    jov.apply(JaxSession(conf).from_arrow(t).select(
        "i", o=_cases(JE)[case]()).plan)
    pov = Overrides(TpuConf(conf), torch.device("cpu"))
    pov.apply(TpuSession(conf, device="cpu").from_arrow(t).select(
        "i", o=_cases(PE)[case]()).plan)
    want = [ln.strip() for ln in jov.explain_string().splitlines()
            if "!" in ln]
    assert [ln.strip() for ln in pov.explain_string().splitlines()
            if "!" in ln] == want
    assert bool(want) == (case == "initcap" and bool(conf.get(
        "spark.rapids.sql.incompatibleOps.enabled") is False))
