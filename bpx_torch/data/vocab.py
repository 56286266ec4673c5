"""Vocabulary (counterpart: ``bpx/data/vocab.py``).

``stoi``/``itos``/``vocab_sz``, populated from a BERT vocab file or a word
list.
"""

from __future__ import annotations

from typing import Dict, Iterable, List


class Vocab:
    RESERVED = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]

    def __init__(self, emptyInit: bool = False):
        if emptyInit:
            self.stoi: Dict[str, int] = {}
            self.itos: List[str] = []
            self.vocab_sz = 0
        else:
            self.stoi = {w: i for i, w in enumerate(self.RESERVED)}
            self.itos = list(self.RESERVED)
            self.vocab_sz = len(self.itos)

    def add(self, words: Iterable[str]):
        for w in words:
            if w not in self.stoi:
                self.stoi[w] = len(self.itos)
                self.itos.append(w)
        self.vocab_sz = len(self.itos)

    @classmethod
    def from_bert_vocab_file(cls, path: str) -> "Vocab":
        v = cls(emptyInit=True)
        # strip \r too: a CRLF vocab.txt must index identically to the
        # native loader (csrc/wordpiece.cpp), or '[UNK]' lookups KeyError
        with open(path, encoding="utf-8") as f:
            v.itos = [line.rstrip("\r\n") for line in f if line.rstrip("\r\n")]
        v.stoi = {w: i for i, w in enumerate(v.itos)}
        v.vocab_sz = len(v.itos)
        return v
