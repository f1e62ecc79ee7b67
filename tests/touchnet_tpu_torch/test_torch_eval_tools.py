# The port's stage-4 scoring tools (touchnet_tpu_torch/bin/textnorm_zh.py,
# error_rate_zh.py, copies of the JAX package's pure-Python tools) against
# touchnet_tpu.bin's on the cases and golden corpus of
# tests/touchnet_tpu/bin/test_eval_tools.py: each case is one parametrised
# test, and each must give exactly the JAX function's result and the
# golden value. The two command lines (the recipe's flags, run.sh:197-212)
# write the same files and print the same summary.

import io
import os

import pytest

from touchnet_tpu.bin import error_rate_zh as jer
from touchnet_tpu.bin import textnorm_zh as jtn
from touchnet_tpu_torch.bin import error_rate_zh as ter
from touchnet_tpu_torch.bin import textnorm_zh as ttn

HANZI = [
    ("0", True, "零"), ("7", True, "七"), ("10", True, "十"), ("14", True, "十四"),
    ("105", True, "一百零五"), ("1234", True, "一千两百三十四"),
    ("1234", False, "一千二百三十四"), ("10000", True, "一万"), ("100050", True, "十万零五十"),
    ("22000", True, "两万两千"), ("10200", True, "一万零二百"), ("3.14", True, "三点一四"),
    ("2.5", True, "二点五"), ("-5", True, "负五"),
]
GOLDENS = [  # test_eval_tools.test_textnorm_matches_reference_goldens
    ("今天3月5日天气好", "今天三月五日天气好"),
    ("2024年10月1号出发", "二零二四年十月一号出发"),
    ("89年的事了", "八九年的事了"),
    ("增长了20%，达到3.5%的水平", "增长了百分之二十 达到百分之三点五的水平"),
    ("价格是1200元", "价格是一千两百元"),
    ("他花了5块3毛钱", "他花了五块三毛钱"),
    ("总共2000万元人民币", "总共两千万元人民币"),
    ("电话是13912345678请记下", "电话是一三九一二三四五六七八请记下"),
    ("座机010-62345678转101", "座机零一零六二三四五六七八转一百零一"),
    ("比例是3/4左右", "比例是四分之三左右"),
    ("买了3条鱼和20只鸡", "买了三条鱼和二十只鸡"),
    ("编号123456789的设备", "编号一二三四五六七八九的设备"),
    ("一共22000人", "一共二二零零零人"),
    ("P2P网络和B2B平台", "P2P网络和B2B平台"),
    ("3.14是圆周率", "三点一四是圆周率"),
    ("他女儿在那边儿玩儿", "他女儿在那边玩"),
    ("１２３ＡＢＣ全角", "一百二十三ABC全角"),
    ("呃这个啊就是个例子", "这个就是个例子"),
    ("100050个", "十万零五十个"),
    ("10200元", "一万零二百元"),
    ("有200个", "有两百个"),
    ("1234人", "一二三四人"),
    ("温度-5度到10度", "温度 五度到十度"),
]
CORPUS = os.path.join(os.path.dirname(__file__), "..", "assets", "textnorm", "goldens.tsv")
with open(CORPUS, encoding="utf-8") as _f:
    CORPUS_LINES = [tuple(ln.rstrip("\n").split("\t")) for ln in _f]
NORMALIZE = [
    ("今天３月5日，天气好！", "今天三月五日 天气好"), ("增长了20%", "增长了百分之二十"),
    ("2024年", "二零二四年"), ("嗯我知道了", "嗯我知道了"), ("呃我啊知道了", "我知道了"),
    ("hello world", "HELLO WORLD"), ("一会儿见", "一会见"), ("我的女儿", "我的女儿"),
]
TEXTNORM_OPTIONS = [  # (TextNorm kwargs, input, golden)
    ({"check_chars": True}, "正常句子", "正常句子"),
    ({"check_chars": True}, "бред", ""),
    ({"to_lower": True}, "ABC", "abc"),
    ({"remove_space": True}, "AB C 你 好 D", "AB C你好D"),
]


def _recipe_norm(mod):
    return mod.TextNorm(to_banjiao=True, to_upper=True, remove_fillers=True, remove_erhua=True)


@pytest.mark.parametrize("num,liang,want", HANZI)
def test_number_to_hanzi(num, liang, want):
    got = ttn.number_to_hanzi(num, liang=liang)
    assert got == jtn.number_to_hanzi(num, liang=liang) == want


@pytest.mark.parametrize("raw,want", GOLDENS + CORPUS_LINES)
def test_textnorm_goldens(raw, want):
    assert len(CORPUS_LINES) == 104
    assert _recipe_norm(ttn)(raw) == _recipe_norm(jtn)(raw) == want


@pytest.mark.parametrize("raw,want", NORMALIZE)
def test_normalize(raw, want):
    assert ttn.normalize(raw) == jtn.normalize(raw) == want


@pytest.mark.parametrize("kwargs,raw,want", TEXTNORM_OPTIONS)
def test_textnorm_options(kwargs, raw, want):
    assert ttn.TextNorm(**kwargs)(raw) == jtn.TextNorm(**kwargs)(raw) == want
    assert ttn.read_digits("010") == jtn.read_digits("010") == "零一零"
    assert ttn.remove_space("AB C 你 好 D") == jtn.remove_space("AB C 你 好 D")


@pytest.mark.parametrize("text,mode,want", [
    ("你好world再见", "mixed", ["你", "好", "world", "再", "见"]),
    ("ABC 123", "mixed", ["ABC", "123"]),
    ("你好 WORLD", "char", ["你", "好", "W", "O", "R", "L", "D"]),
    ("你好 WORLD", "whitespace", ["你好", "WORLD"]),
    ("你好WORLD", "mixed", ["你", "好", "WORLD"]),
])
def test_tokenize(text, mode, want):
    assert ter.tokenize(text, mode) == jer.tokenize(text, mode) == want


@pytest.mark.parametrize("ref,hyp,want", [
    ("今天天气", "今天气", (3, 0, 1, 0)), ("abc", "axcd", (2, 1, 0, 1)),
    ("", "ab", (0, 0, 0, 2)), ("ab", "", (0, 0, 2, 0)),
])
def test_align(ref, hyp, want):
    got = ter.align(list(ref), list(hyp))
    assert got == jer.align(list(ref), list(hyp)) and got[:4] == want


@pytest.mark.parametrize("tokenizer,case_sensitive", [
    ("mixed", True), ("char", True), ("char", False), ("whitespace", True),
])
def test_score_pairs_and_summary(tokenizer, case_sensitive):
    pairs = [("u1", "今天天气好", "今天天气好"), ("u2", "今天天气好", "今天气好了"),
             ("good", "今天天气", "今天天气"), ("bad", "今天天气", "明天下雨"),
             ("u3", "abc", "ABC"), ("u4", "好", "好")]
    outs = []
    for mod in (ter, jer):
        buf = io.StringIO()
        wer, total = mod.score_pairs(pairs, buf, tokenizer=tokenizer,
                                     case_sensitive=case_sensitive)
        outs.append((wer, total, buf.getvalue(), mod.summary_block(wer, total, 2)))
    assert outs[0] == outs[1]
    body = outs[0][2]
    assert body.index("utt: bad") < body.index("utt: good")  # worst first
    wer, total = ter.score_pairs(pairs[:2])
    assert abs(wer - 20.0) < 1e-6 and total["ref_len"] == 10


@pytest.mark.parametrize("tokenizer", ["char", "mixed"])
def test_the_recipes_command_lines(tmp_path, tokenizer, capsys):
    """textnorm_zh --format=ark with the recipe's flags on both sides, then
    error_rate_zh --ref --hyp --detail: the same files and the same summary
    as the JAX package's command lines."""
    trans = tmp_path / "trans.txt"
    trans.write_text("u1\t今天3月5日天气好\nu2\t价格是1200元\nu3\thello world\n", encoding="utf8")
    raw = tmp_path / "raw_rec.txt"
    raw.write_text("u1\t今天三月五号天气好\nu2\t\nu3\tHELLO WORD\n", encoding="utf8")
    printed = []
    for name, tn, er in (("port", ttn, ter), ("jax", jtn, jer)):
        out = tmp_path / name
        out.mkdir()
        for src, dst in ((trans, "ref.txt"), (raw, "rec.txt")):
            tn.main(["--format=ark", "--to_upper", "--to_banjiao", "--remove_fillers",
                     "--remove_erhua", str(src), str(out / dst)])
        wer = er.main(["--tokenizer", tokenizer, "--ref", str(out / "ref.txt"), "--hyp",
                       str(out / "rec.txt"), "--detail", str(out / "DETAILS.txt")])
        printed.append((wer, capsys.readouterr().out))
    for f in ("ref.txt", "rec.txt", "DETAILS.txt"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    assert printed[0] == printed[1]
    assert "num_eval_utts: 3" in printed[0][1]  # u2's empty hyp still scored
