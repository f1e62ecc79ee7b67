# Copyright (c) 2026 touchnet_tpu authors.
# Copied from touchnet_tpu/bin/error_rate_zh.py (pure Python: the standard library
# only), so the port scores stage 4 without importing the JAX package:
#     python -m touchnet_tpu_torch.bin.error_rate_zh ...
#
# WER/CER scorer with alignment (SpeechIO style).
#
# Capability parity: reference touchnet/bin/error_rate_zh — tokenize
# hypotheses/references (Chinese chars as units, Latin words as units),
# Levenshtein alignment, per-utt and corpus substitution/deletion/insertion
# counts, overall error rate. Fresh implementation.

import argparse
import json
import sys
import unicodedata
from typing import List, Tuple


def tokenize_mixed(text: str) -> List[str]:
    """CJK chars are single tokens; contiguous Latin/digit runs are words."""
    tokens: List[str] = []
    word = []
    for ch in text:
        if ch.isspace():
            if word:
                tokens.append("".join(word))
                word = []
            continue
        cjk = "CJK" in unicodedata.name(ch, "")
        if cjk:
            if word:
                tokens.append("".join(word))
                word = []
            tokens.append(ch)
        else:
            word.append(ch)
    if word:
        tokens.append("".join(word))
    return tokens


def align(ref: List[str], hyp: List[str]) -> Tuple[int, int, int, int, list]:
    """Levenshtein alignment. Returns (hits, subs, dels, ins, ops)."""
    R, H = len(ref), len(hyp)
    # dp[i][j] = (cost, op) op in {'=', 'S', 'D', 'I'}
    INF = 10**9
    cost = [[0] * (H + 1) for _ in range(R + 1)]
    back = [[""] * (H + 1) for _ in range(R + 1)]
    for i in range(1, R + 1):
        cost[i][0] = i
        back[i][0] = "D"
    for j in range(1, H + 1):
        cost[0][j] = j
        back[0][j] = "I"
    for i in range(1, R + 1):
        for j in range(1, H + 1):
            match = cost[i - 1][j - 1] + (0 if ref[i - 1] == hyp[j - 1] else 1)
            delete = cost[i - 1][j] + 1
            insert = cost[i][j - 1] + 1
            best = min(match, delete, insert)
            cost[i][j] = best
            if best == match:
                back[i][j] = "=" if ref[i - 1] == hyp[j - 1] else "S"
            elif best == delete:
                back[i][j] = "D"
            else:
                back[i][j] = "I"
    # trace back
    ops = []
    i, j = R, H
    while i > 0 or j > 0:
        op = back[i][j] if (i > 0 or j > 0) else "="
        if i > 0 and j > 0 and op in ("=", "S"):
            ops.append((op, ref[i - 1], hyp[j - 1]))
            i -= 1
            j -= 1
        elif i > 0 and (j == 0 or op == "D"):
            ops.append(("D", ref[i - 1], ""))
            i -= 1
        else:
            ops.append(("I", "", hyp[j - 1]))
            j -= 1
    ops.reverse()
    hits = sum(1 for o in ops if o[0] == "=")
    subs = sum(1 for o in ops if o[0] == "S")
    dels = sum(1 for o in ops if o[0] == "D")
    ins = sum(1 for o in ops if o[0] == "I")
    return hits, subs, dels, ins, ops


def tokenize(text: str, tokenizer: str = "mixed") -> List[str]:
    """Tokenization modes (reference error_rate_zh --tokenizer):
    'whitespace' for word-level WER, 'char' for CER (every non-space char a
    token), 'mixed' (default) CJK chars as units + Latin words as units."""
    if tokenizer == "whitespace":
        return text.split()
    if tokenizer == "char":
        return [c for c in text if not c.isspace()]
    return tokenize_mixed(text)


def score_pairs(pairs, detail_out=None, tokenizer: str = "mixed",
                case_sensitive: bool = True):
    """Corpus scoring. Per-utt details (when requested) are emitted sorted
    by descending utterance error rate (worst first — the reference's
    sorted report), followed by an overall-statistics summary block."""
    total = {"hits": 0, "subs": 0, "dels": 0, "ins": 0, "ref_len": 0,
             "utts": 0, "err_utts": 0}
    per_utt = []
    for key, ref_text, hyp_text in pairs:
        if not case_sensitive:
            ref_text, hyp_text = ref_text.upper(), hyp_text.upper()
        ref = tokenize(ref_text, tokenizer)
        hyp = tokenize(hyp_text, tokenizer)
        hits, subs, dels, ins, ops = align(ref, hyp)
        total["hits"] += hits
        total["subs"] += subs
        total["dels"] += dels
        total["ins"] += ins
        total["ref_len"] += len(ref)
        total["utts"] += 1
        nerr = subs + dels + ins
        if nerr:
            total["err_utts"] += 1
        if detail_out is not None:
            er = nerr / max(len(ref), 1) * 100
            per_utt.append((er, key, ref, hyp, subs, dels, ins))
    if detail_out is not None:
        for er, key, ref, hyp, subs, dels, ins in sorted(
            per_utt, key=lambda x: (-x[0], x[1])
        ):
            detail_out.write(f"utt: {key}\n")
            detail_out.write(f"ref: {' '.join(ref)}\n")
            detail_out.write(f"hyp: {' '.join(hyp)}\n")
            detail_out.write(
                f"WER: {er:.2f}% N={len(ref)} S={subs} D={dels} I={ins}\n\n"
            )
    n = max(total["ref_len"], 1)
    wer = 100.0 * (total["subs"] + total["dels"] + total["ins"]) / n
    return wer, total


def summary_block(wer: float, total: dict, num_hyp_without_ref: int = 0) -> str:
    """Overall-statistics block (reference to_summary format)."""
    ser = 100.0 * total["err_utts"] / max(total["utts"], 1)
    edits = total["subs"] + total["dels"] + total["ins"]
    return (
        "==================== Overall Statistics ====================\n"
        f"num_eval_utts: {total['utts']}\n"
        f"num_hyp_without_ref: {num_hyp_without_ref}\n"
        f"sentence_error_rate: {ser:.2f}%\n"
        f"token_error_rate: {wer:.2f}%\n"
        "token_stats:\n"
        f"  - tokens:{total['ref_len']:>7}\n"
        f"  - edits: {edits:>7}\n"
        f"  - cor:   {total['hits']:>7}\n"
        f"  - sub:   {total['subs']:>7}\n"
        f"  - ins:   {total['ins']:>7}\n"
        f"  - del:   {total['dels']:>7}\n"
        "============================================================"
    )


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="WER/CER scorer: inputs are jsonl with {key, txt, hyp} "
        "or parallel ref/hyp files of '<key>\\t<text>' lines."
    )
    parser.add_argument("--jsonl", help="part file(s) with key/txt/hyp",
                        nargs="*")
    parser.add_argument("--ref", help="reference trn file")
    parser.add_argument("--hyp", help="hypothesis trn file")
    parser.add_argument("--detail", help="alignment detail output path")
    parser.add_argument("--tokenizer", choices=["whitespace", "char", "mixed"],
                        default="mixed",
                        help="whitespace for WER, char for CER, mixed for "
                             "CJK-chars + latin-words")
    parser.add_argument("--case_insensitive", action="store_true",
                        help="fold case before scoring")
    args = parser.parse_args(argv)

    pairs = []
    if args.jsonl:
        for path in args.jsonl:
            with open(path, encoding="utf8") as f:
                for line in f:
                    rec = json.loads(line)
                    pairs.append((rec["key"], rec.get("txt", ""),
                                  rec.get("hyp", "")))
    else:
        def read_trn(path):
            out = {}
            with open(path, encoding="utf8") as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t", 1) if "\t" in line \
                        else line.rstrip("\n").split(maxsplit=1)
                    if parts:
                        out[parts[0]] = parts[1] if len(parts) > 1 else ""
            return out

        refs = read_trn(args.ref)
        hyps = read_trn(args.hyp)
        for key in refs:
            pairs.append((key, refs[key], hyps.get(key, "")))

    num_hyp_without_ref = 0
    if args.ref and args.hyp and not args.jsonl:
        num_hyp_without_ref = len(set(hyps) - set(refs))
    detail = open(args.detail, "w", encoding="utf8") if args.detail else None
    wer, total = score_pairs(
        pairs, detail, tokenizer=args.tokenizer,
        case_sensitive=not args.case_insensitive,
    )
    summary = summary_block(wer, total, num_hyp_without_ref)
    if detail:
        detail.write(summary + "\n")
        detail.close()
    print(
        f"Overall -> {wer:.2f}% N={total['ref_len']} "
        f"C={total['hits']} S={total['subs']} D={total['dels']} I={total['ins']}"
    )
    print(summary)
    return wer


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
