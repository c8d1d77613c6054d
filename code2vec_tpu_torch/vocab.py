"""Vocabularies: word <-> index maps for tokens, AST paths and target names.

Bit-compatible with the `dictionaries.bin` sidecar that code2vec_tpu
writes (code2vec_tpu/vocab.py): the three vocabs are stored WITHOUT their
special words, in token / target / path order, each as three pickles
(word->index, index->word, size). Special words come first in each vocab:
the default scheme joins PAD and OOV into `<PAD_OR_OOV>` at index 0; with
`separate_oov_and_pad` token and path vocabs get `<PAD>`, `<OOV>` and the
target vocab only `<OOV>`.
"""

from __future__ import annotations

import enum
import pickle
from typing import Dict, Iterable, List, NamedTuple

PAD_OR_OOV = "<PAD_OR_OOV>"
PAD = "<PAD>"
OOV = "<OOV>"


class VocabType(enum.Enum):
    Token = 1
    Target = 2
    Path = 3


class SpecialWords(NamedTuple):
    pad: str
    oov: str

    @property
    def unique(self) -> List[str]:
        return [self.pad] if self.pad == self.oov else [self.pad, self.oov]


def special_words_for(vocab_type: VocabType,
                      separate_oov_and_pad: bool) -> SpecialWords:
    if not separate_oov_and_pad:
        return SpecialWords(pad=PAD_OR_OOV, oov=PAD_OR_OOV)
    if vocab_type == VocabType.Target:
        return SpecialWords(pad=OOV, oov=OOV)
    return SpecialWords(pad=PAD, oov=OOV)


class Vocab:
    """One word <-> index vocabulary with its special words in front."""

    def __init__(self, vocab_type: VocabType, words: Iterable[str],
                 special_words: SpecialWords):
        self.vocab_type = vocab_type
        self.special_words = special_words
        self.word_to_index: Dict[str, int] = {}
        self.index_to_word: Dict[int, str] = {}
        for index, word in enumerate(list(special_words.unique) + list(words)):
            self.word_to_index[word] = index
            self.index_to_word[index] = word
        self.size = len(self.word_to_index)

    @property
    def pad_index(self) -> int:
        return self.word_to_index[self.special_words.pad]

    @property
    def oov_index(self) -> int:
        return self.word_to_index[self.special_words.oov]

    def lookup_index(self, word: str) -> int:
        return self.word_to_index.get(word, self.oov_index)

    def lookup_word(self, index: int) -> str:
        return self.index_to_word.get(index, self.special_words.oov)

    @classmethod
    def create_from_freq_dict(cls, vocab_type: VocabType,
                              word_to_count: Dict[str, int], max_size: int,
                              special_words: SpecialWords) -> "Vocab":
        """Top `max_size` words by count; ties keep the dict's insertion
        order (a stable sort, code2vec_tpu/vocab.py:99-104)."""
        words = sorted(word_to_count, key=word_to_count.get,
                       reverse=True)[:max_size]
        return cls(vocab_type, words, special_words)

    def save_to_file(self, file) -> None:
        nr_special = len(self.special_words.unique)
        w2i = {w: i for w, i in self.word_to_index.items() if i >= nr_special}
        i2w = {i: w for i, w in self.index_to_word.items() if i >= nr_special}
        pickle.dump(w2i, file)
        pickle.dump(i2w, file)
        pickle.dump(self.size - nr_special, file)

    @classmethod
    def load_from_file(cls, vocab_type: VocabType, file,
                       special_words: SpecialWords) -> "Vocab":
        w2i = pickle.load(file)
        i2w = pickle.load(file)
        size_wo_specials = pickle.load(file)
        if not len(i2w) == len(w2i) == size_wo_specials:
            raise ValueError(f"corrupt {vocab_type} vocabulary: "
                             f"{len(w2i)} words, {len(i2w)} indices, "
                             f"declared size {size_wo_specials}")
        specials = special_words.unique
        min_idx = min(i2w.keys())
        if min_idx != len(specials):
            raise ValueError(
                f"Stored vocabulary {vocab_type} has minimum word index "
                f"{min_idx}, expected {len(specials)} (number of special "
                f"words {specials}). Check `separate_oov_and_pad`.")
        vocab = cls(vocab_type, [], special_words)
        vocab.word_to_index = {**w2i, **{w: i for i, w in enumerate(specials)}}
        vocab.index_to_word = {**i2w, **{i: w for i, w in enumerate(specials)}}
        vocab.size = size_wo_specials + len(specials)
        return vocab


class WordFreqDicts(NamedTuple):
    token_to_count: Dict[str, int]
    path_to_count: Dict[str, int]
    target_to_count: Dict[str, int]
    num_train_examples: int


def load_word_freq_dicts(dict_c2v_path: str) -> WordFreqDicts:
    """The `.dict.c2v` pickle of preprocessing: token, path and target
    frequency dicts, then the train example count (absent in old files)."""
    with open(dict_c2v_path, "rb") as f:
        token_to_count = pickle.load(f)
        path_to_count = pickle.load(f)
        target_to_count = pickle.load(f)
        try:
            num_train_examples = pickle.load(f)
        except EOFError:
            num_train_examples = 0
    return WordFreqDicts(token_to_count, path_to_count, target_to_count,
                         num_train_examples)


class Code2VecVocabs:
    """The token, path and target vocabularies of one model."""

    def __init__(self, token_vocab: Vocab, path_vocab: Vocab,
                 target_vocab: Vocab):
        self.token_vocab = token_vocab
        self.path_vocab = path_vocab
        self.target_vocab = target_vocab

    @classmethod
    def from_words(cls, token_words: Iterable[str],
                   path_words: Iterable[str], target_words: Iterable[str],
                   separate_oov_and_pad: bool = False) -> "Code2VecVocabs":
        def make(vocab_type, words):
            return Vocab(vocab_type, words,
                         special_words_for(vocab_type, separate_oov_and_pad))
        return cls(make(VocabType.Token, token_words),
                   make(VocabType.Path, path_words),
                   make(VocabType.Target, target_words))

    @classmethod
    def create_from_freq_dicts(cls, freq: WordFreqDicts, *,
                               max_token_vocab_size: int,
                               max_path_vocab_size: int,
                               max_target_vocab_size: int,
                               separate_oov_and_pad: bool = False
                               ) -> "Code2VecVocabs":
        def make(vocab_type, counts, max_size):
            return Vocab.create_from_freq_dict(
                vocab_type, counts, max_size,
                special_words_for(vocab_type, separate_oov_and_pad))
        return cls(make(VocabType.Token, freq.token_to_count,
                        max_token_vocab_size),
                   make(VocabType.Path, freq.path_to_count,
                        max_path_vocab_size),
                   make(VocabType.Target, freq.target_to_count,
                        max_target_vocab_size))

    @classmethod
    def load_or_create(cls, config) -> "Code2VecVocabs":
        """Vocabularies of a training run, built from the data's
        `.dict.c2v` (code2vec_tpu/vocab.py:192-209 without `--load`,
        which the port does not take yet)."""
        if not config.is_training:
            raise ValueError("load_or_create needs a training data prefix "
                             "(--data); loading a saved model is not "
                             "ported yet")
        freq = load_word_freq_dicts(config.word_freq_dict_path)
        return cls.create_from_freq_dicts(
            freq, max_token_vocab_size=config.max_token_vocab_size,
            max_path_vocab_size=config.max_path_vocab_size,
            max_target_vocab_size=config.max_target_vocab_size,
            separate_oov_and_pad=config.separate_oov_and_pad)

    @classmethod
    def load(cls, path: str,
             separate_oov_and_pad: bool = False) -> "Code2VecVocabs":
        with open(path, "rb") as f:
            token_vocab = Vocab.load_from_file(
                VocabType.Token, f,
                special_words_for(VocabType.Token, separate_oov_and_pad))
            target_vocab = Vocab.load_from_file(
                VocabType.Target, f,
                special_words_for(VocabType.Target, separate_oov_and_pad))
            path_vocab = Vocab.load_from_file(
                VocabType.Path, f,
                special_words_for(VocabType.Path, separate_oov_and_pad))
        return cls(token_vocab, path_vocab, target_vocab)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            self.token_vocab.save_to_file(f)
            self.target_vocab.save_to_file(f)
            self.path_vocab.save_to_file(f)
