"""Self-contained BERT WordPiece tokenization (counterpart:
``bpx/data/tokenization.py``).

Basic tokenizer (lowercase, accent strip, punctuation/CJK split), then
greedy longest-match-first WordPiece with ``##`` continuations, from a
local ``vocab.txt``.  For data with no vocab file, :class:`HashTokenizer`
gives a deterministic whitespace+hash fallback.
"""

from __future__ import annotations

import unicodedata
from typing import List, Optional

from bpx_torch.data.vocab import Vocab


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


class BasicTokenizer:
    """Whitespace/punctuation/CJK splitting with lowercasing + accent strip."""

    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        text = "".join(" " if _is_whitespace(c) else c
                       for c in text if not (_is_control(c) or ord(c) == 0
                                             or ord(c) == 0xFFFD))
        # CJK chars get surrounding spaces
        text = "".join(f" {c} " if _is_cjk(ord(c)) else c for c in text)
        tokens = []
        for tok in text.strip().split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                              if unicodedata.category(c) != "Mn")
            tokens.extend(self._split_punct(tok))
        return tokens

    @staticmethod
    def _split_punct(token: str) -> List[str]:
        out, cur = [], []
        for ch in token:
            if _is_punctuation(ch):
                if cur:
                    out.append("".join(cur))
                    cur = []
                out.append(ch)
            else:
                cur.append(ch)
        if cur:
            out.append("".join(cur))
        return out


class WordPieceTokenizer:
    """BERT tokenization: basic split + greedy WordPiece."""

    def __init__(self, vocab: Vocab, do_lower_case: bool = True,
                 unk_token: str = "[UNK]", max_chars_per_word: int = 100):
        self.vocab = vocab
        self.basic = BasicTokenizer(do_lower_case)
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word

    def tokenize(self, text: str) -> List[str]:
        out = []
        for word in self.basic.tokenize(text):
            out.extend(self._wordpiece(word))
        return out

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        stoi = self.vocab.stoi
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in stoi:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def encode(self, text: str, max_len: int,
               cls_token: str = "[CLS]") -> List[int]:
        """``[CLS]`` + pieces, truncated to max_len."""
        tokens = [cls_token] + self.tokenize(text)[: max_len - 1]
        unk = self.vocab.stoi[self.unk_token]
        return [self.vocab.stoi.get(t, unk) for t in tokens]


class HashTokenizer:
    """Deterministic fallback for data without a vocab: whitespace split,
    tokens hashed into a fixed id range (ids 5.. to skip the reserved
    slots)."""

    def __init__(self, vocab_size: int = 1024):
        self.vocab_size = vocab_size
        self.cls_id = 2
        self.unk_id = 1

    def encode(self, text: str, max_len: int) -> List[int]:
        ids = [self.cls_id]
        for tok in text.split()[: max_len - 1]:
            ids.append(5 + (hash(tok) % (self.vocab_size - 5)))
        return ids


def build_tokenizer(bert_vocab_path: Optional[str] = None,
                    vocab_size: int = 1024,
                    use_native: bool = True):
    """WordPiece from a local vocab.txt when given, else the hash
    tokenizer.  ``use_native`` wraps the Python tokenizer with the C++ one
    (:mod:`bpx_torch.data.native`) when ``g++`` builds it; it gives the same
    ids, and where it is not built the Python tokenizer is used as is."""
    if bert_vocab_path:
        vocab = Vocab.from_bert_vocab_file(bert_vocab_path)
        tokenizer = WordPieceTokenizer(vocab)
        if use_native:
            from bpx_torch.data.native import NativeWordPieceTokenizer
            native = NativeWordPieceTokenizer(bert_vocab_path, tokenizer)
            if native.is_native:
                return native, vocab
        return tokenizer, vocab
    vocab = Vocab()
    vocab.vocab_sz = vocab_size
    return HashTokenizer(vocab_size), vocab
