"""Text analysis in the port against the JAX package on the CPU.

- Every built-in analyzer, tokenizer, token filter (each parameter a case
  of one parametrised test), char filter and normalizer of both packages'
  registries runs over one fixed corpus (ASCII, accented Latin, HTML,
  Chinese, Japanese, Korean, Polish, Ukrainian, possessives such as
  `john's`) and over 200 seeded random strings of those scripts (numpy
  seed 17). Tokens must be equal: text, position, offsets and the keyword
  flag.
- The reference runs a standard + lowercase chain's ASCII text through its
  C++ tokenizer (`native.tokenize_ascii`); the port's Python tokenizer
  must give the same tokens and offsets, on ASCII and non-ASCII text.
- `indices.analyze` by analyzer, by field, on an index and with none: the
  responses must be equal; an unknown analyzer is the reference's
  ValueError in both.
- Queue 3 decisions: `english` is std -> lowercase -> stop -> porter, as
  the reference's (Lucene's EnglishAnalyzer also runs the possessive
  filter and the keyword marker); `smartcn` raises naming `jieba` where it
  is missing (the reference falls back to script-run tokens).

The tolerance is exact equality throughout.
"""

import copy
import sys

import jax
import numpy as np
import pytest

from opensearch_tpu.analysis import analyzers as ranalyzers
from opensearch_tpu.analysis import cjk_morph as rcjk
from opensearch_tpu.analysis import filters as rfilters
from opensearch_tpu.analysis import tokenizers as rtok
from opensearch_tpu.cluster.node import Node
from opensearch_tpu.rest.client import RestClient as RefClient
from opensearch_tpu_torch import RestClient
from opensearch_tpu_torch.analysis import analyzers as panalyzers
from opensearch_tpu_torch.analysis import cjk_morph as pcjk
from opensearch_tpu_torch.analysis import filters as pfilters
from opensearch_tpu_torch.analysis import tokenizers as ptok

jax.config.update("jax_platforms", "cpu")

CORPUS = [
    "The quick brown foxes jumped over the lazy dogs' kennels",
    "John's running shoes aren't cheap; they're RUNNING-fast!",
    "Café Résumé naïve coöperate Ærøskøbing straße Ｆｕｌｌｗｉｄｔｈ ＡＢＣ１２３",
    "<p>Hello <b>world</b> &amp; friends &lt;3</p> ph-phone",
    "北京故宫博物院是中国最大的博物馆。我们在北京大学学习中文",
    "東京都の観光案内所でカタカナとひらがなを調べました。ＡＢＣ",
    "한국어를 공부하는 학생들이 서울에서 만났습니다",
    "Zażółć gęślą jaźń; książkami, domach, kotów i psów",
    "Україна має багато міст; книжками, будинках, українського",
    "WiFi-Router2000 PowerShot500X l'avion d'Artagnan qu'il",
    "O'Neil's dog's bone, the children's toys… 3.14 and 1,000",
    "٣٤٥ ১২৩ digits ４５６ mixed",
    "",
    "   ",
]
ALPHABETS = ["abcdefghij ", "ÀÉÎÕÜçñ ", "<b>&; ", "北京故宫大学中文", "ひらがなカタカナ",
             "한국어학생", "ąęłńóśźż ", "їєґабвгд ", "'’-_.,0123 "]


def _random_texts(n: int = 200) -> list:
    rng = np.random.default_rng(17)
    out = []
    for _ in range(n):
        parts = []
        for _ in range(int(rng.integers(1, 5))):
            alpha = ALPHABETS[int(rng.integers(len(ALPHABETS)))]
            parts.append("".join(rng.choice(list(alpha),
                                            int(rng.integers(1, 12)))))
        out.append(" ".join(parts))
    return out


TEXTS = CORPUS + _random_texts()
BUILTINS = ["standard", "simple", "whitespace", "keyword", "stop", "english",
            "cjk", "smartcn", "kuromoji", "nori", "icu_analyzer", "polish",
            "ukrainian"]
TOKENIZERS = [
    ("standard", {}), ("whitespace", {}), ("letter", {}), ("keyword", {}),
    ("lowercase", {}), ("pattern", {}), ("pattern", {"pattern": "[-\\s]+"}),
    ("pattern", {"pattern": "(\\w)(\\w+)", "group": 2}),
    ("pattern", {"pattern": "\\d+", "group": 0}), ("ngram", {}),
    ("ngram", {"min_gram": 2, "max_gram": 3}), ("edge_ngram", {}),
    ("edge_ngram", {"min_gram": 1, "max_gram": 5})]
FILTERS = [
    ("lowercase", {}), ("uppercase", {}), ("porter_stem", {}),
    ("stemmer", {}), ("asciifolding", {}), ("trim", {}), ("unique", {}),
    ("reverse", {}), ("decimal_digit", {}), ("apostrophe", {}),
    ("flatten_graph", {}),
    ("word_delimiter", {}),
    ("word_delimiter_graph", {"catenate_words": True,
                              "preserve_original": True}),
    ("word_delimiter", {"catenate_numbers": True, "generate_word_parts":
                        False}),
    ("word_delimiter", {"catenate_all": True, "split_on_case_change": False,
                        "split_on_numerics": False}),
    ("pattern_capture", {"patterns": ["([a-z]+)", "(\\d+)"]}),
    ("pattern_capture", {"patterns": ["[aeiou]"],
                         "preserve_original": False}),
    ("elision", {}), ("elision", {"articles": ["l", "d"]}),
    ("ngram", {}), ("ngram", {"min_gram": 2, "max_gram": 3}),
    ("edge_ngram", {}), ("edge_ngram", {"min_gram": 1, "max_gram": 4}),
    ("keyword_marker", {"keywords": ["running", "Dogs"]}),
    ("keyword_marker", {"keywords": ["RUNNING"], "ignore_case": True}),
    ("stemmer_override", {"rules": ["running => run", "dogs => dog"]}),
    ("limit", {}), ("limit", {"max_token_count": 3}),
    ("synonym_graph", {"synonyms": ["quick, fast", "dog => hound"]}),
    ("synonym", {"synonyms": ["fox, vixen, tod", "lazy, idle => slow"]}),
    ("stop", {}), ("stop", {"stopwords": ["quick", "the"]}),
    ("length", {}), ("length", {"min": 3, "max": 6}),
    ("truncate", {}), ("truncate", {"length": 3}),
    ("shingle", {}),
    ("shingle", {"min_shingle_size": 2, "max_shingle_size": 3,
                 "token_separator": "_", "output_unigrams": False}),
    ("icu_folding", {}), ("icu_normalizer", {}), ("cjk_width", {}),
    ("cjk_bigram", {}), ("icu_transform", {}),
    ("icu_transform", {"id": "Latin-ASCII"}),
    ("icu_transform", {"id": "Cyrillic-Latin; Any-Lower"}),
    ("icu_transform", {"id": "NFD; [:Nonspacing Mark:] Remove; NFC"}),
    ("phonetic", {}), ("phonetic", {"encoder": "soundex"}),
    ("phonetic", {"encoder": "refined_soundex", "replace": False}),
    ("phonetic", {"encoder": "nysiis"}), ("phonetic", {"encoder":
                                                       "caverphone2"}),
    ("phonetic", {"encoder": "caverphone"}),
    ("phonetic", {"encoder": "cologne"}),
    ("phonetic", {"encoder": "koelnerphonetik", "replace": False}),
    ("polish_stem", {}), ("ukrainian_stem", {})]
CHAR_FILTERS = [("html_strip", {}), ("mapping", {"mappings": [
    "ph => f", "& => and", "ü => ue"]}),
    ("pattern_replace", {"pattern": "(\\d+)", "replacement": "<$1>"}),
    ("pattern_replace", {"pattern": "[aeiou]"}), ("icu_normalizer", {})]


def _toks(tokens) -> list:
    return [(t.text, t.position, t.start_offset, t.end_offset, t.keyword)
            for t in tokens]


def _same_over_corpus(ref_fn, port_fn) -> None:
    for text in TEXTS:
        assert _toks(port_fn(text)) == _toks(ref_fn(text)), text


@pytest.mark.parametrize("name", BUILTINS)
def test_builtin_analyzers_match_reference(name):
    ref = ranalyzers.AnalysisRegistry().get(name)
    port = panalyzers.AnalysisRegistry().get(name)
    _same_over_corpus(ref.analyze, port.analyze)


@pytest.mark.parametrize("name,params", TOKENIZERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(TOKENIZERS)])
def test_tokenizers_match_reference(name, params):
    ref = rtok.resolve_tokenizer(name, dict(params))
    port = ptok.resolve_tokenizer(name, dict(params))
    _same_over_corpus(ref, port)


@pytest.mark.parametrize("name,params", FILTERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(FILTERS)])
def test_token_filters_match_reference(name, params):
    """Each filter after the standard tokenizer (keyword-flagged tokens
    where a keyword marker runs first) in a custom chain of both
    registries."""
    settings = {"filter": {"f": dict(params, type=name),
                           "kw": {"type": "keyword_marker",
                                  "keywords": ["running"]}},
                "analyzer": {"a": {"type": "custom", "tokenizer": "standard",
                                   "filter": ["f"]},
                             "b": {"type": "custom", "tokenizer":
                                   "whitespace", "filter": ["kw", "f"]}}}
    for ana in ("a", "b"):
        ref = ranalyzers.AnalysisRegistry(copy.deepcopy(settings)).get(ana)
        port = panalyzers.AnalysisRegistry(copy.deepcopy(settings)).get(ana)
        _same_over_corpus(ref.analyze, port.analyze)


@pytest.mark.parametrize("name,params", CHAR_FILTERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(CHAR_FILTERS)])
def test_char_filters_match_reference(name, params):
    ref = rfilters.resolve_char_filter(name, dict(params))
    port = pfilters.resolve_char_filter(name, dict(params))
    for text in TEXTS:
        assert port(text) == ref(text)
    settings = {"char_filter": {"c": dict(params, type=name)},
                "tokenizer": {"t": {"type": "pattern", "pattern": "\\W+"}},
                "analyzer": {"a": {"type": "custom", "char_filter": ["c"],
                                   "tokenizer": "t",
                                   "filter": ["lowercase"]}}}
    _same_over_corpus(
        ranalyzers.AnalysisRegistry(copy.deepcopy(settings)).get("a").analyze,
        panalyzers.AnalysisRegistry(copy.deepcopy(settings)).get("a").analyze)


@pytest.mark.parametrize("name", [
    None, "lowercase", "_icu_collation:primary", "_icu_collation:secondary",
    "_icu_collation:tertiary", "fold", "strip"])
def test_normalizers_match_reference(name):
    settings = {"char_filter": {"amp": {"type": "mapping",
                                        "mappings": ["& => and"]}},
                "normalizer": {
                    "fold": {"type": "custom",
                             "filter": ["lowercase", "asciifolding"]},
                    "strip": {"type": "custom", "char_filter": ["html_strip",
                                                                "amp"],
                              "filter": ["trim", "uppercase"]}}}
    ref = ranalyzers.AnalysisRegistry(copy.deepcopy(settings)).normalizer(name)
    port = panalyzers.AnalysisRegistry(copy.deepcopy(settings)).normalizer(
        name)
    _same_over_corpus(ref.analyze, port.analyze)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_search_as_you_type_chains_match_reference(n):
    rreg, preg = ranalyzers.AnalysisRegistry(), panalyzers.AnalysisRegistry()
    rreg.ensure_sayt_chains(n)
    preg.ensure_sayt_chains(n)
    assert preg._settings == rreg._settings
    for k in list(range(2, n + 1)):
        _same_over_corpus(rreg.get(f"__sayt_{k}gram").analyze,
                          preg.get(f"__sayt_{k}gram").analyze)
    _same_over_corpus(rreg.get("__sayt_prefix").analyze,
                      preg.get("__sayt_prefix").analyze)


def test_custom_tokenizer_chain_matches_reference():
    settings = {
        "char_filter": {"amp": {"type": "mapping", "mappings": ["& => and"]}},
        "tokenizer": {"dash": {"type": "pattern", "pattern": "[-\\s]+"},
                      "grams": {"type": "edge_ngram", "min_gram": 2,
                                "max_gram": 4}},
        "filter": {"short": {"type": "length", "min": 2},
                   "syn": {"type": "synonym", "synonyms": ["fox, tod"]}},
        "analyzer": {
            "chain": {"type": "custom", "char_filter": ["html_strip", "amp"],
                      "tokenizer": "dash",
                      "filter": ["lowercase", "asciifolding", "short", "syn",
                                 "porter_stem", "unique"]},
            "g": {"tokenizer": "grams"},
            "alias_en": {"type": "english"}}}
    for name in ("chain", "g", "alias_en"):
        _same_over_corpus(
            ranalyzers.AnalysisRegistry(copy.deepcopy(settings)).get(
                name).analyze,
            panalyzers.AnalysisRegistry(copy.deepcopy(settings)).get(
                name).analyze)


def test_native_ascii_tokenizer_matches_the_python_tokenizer():
    """The reference tokenizes a standard + lowercase chain's ASCII text
    in C++; the port's Python tokenizer gives the same tokens and
    offsets (non-ASCII text takes the Python path in both)."""
    from opensearch_tpu import native
    ref = ranalyzers.AnalysisRegistry().get("standard")
    port = panalyzers.AnalysisRegistry().get("standard")
    assert native.available() and ref._std_fast()
    ascii_texts = [t for t in TEXTS if t.isascii()]
    assert len(ascii_texts) > 10
    for text in TEXTS:
        assert _toks(port.analyze(text)) == _toks(ref.analyze(text)), text
    rng = np.random.default_rng(5)
    for _ in range(300):
        text = "".join(rng.choice(list("ab'Z9 _-.\t\n'x"), 40))
        assert _toks(port.analyze(text)) == _toks(ref.analyze(text)), text


@pytest.mark.parametrize("kind,name", [
    ("analyzer", "nope"), ("normalizer", "nope"), ("tokenizer", "nope"),
    ("filter", "nope"), ("char_filter", "nope"),
    ("filter", "phonetic:double_metaphone")])
def test_unknown_names_are_the_reference_value_errors(kind, name):
    def build(mod):
        reg = mod.AnalysisRegistry({
            "analyzer": {"t": {"tokenizer": "nope"},
                         "f": {"tokenizer": "standard", "filter": ["nope"]},
                         "c": {"tokenizer": "standard",
                               "char_filter": ["nope"]},
                         "p": {"tokenizer": "standard", "filter": ["ph"]}},
            "filter": {"ph": {"type": "phonetic",
                              "encoder": "double_metaphone"}}})
        if kind == "analyzer":
            return reg.get(name)
        if kind == "normalizer":
            return reg.normalizer(name)
        return reg.get({"tokenizer": "t", "filter": "f",
                        "char_filter": "c"}[kind]
                       if name == "nope" else "p")
    with pytest.raises(ValueError) as want:
        build(ranalyzers)
    with pytest.raises(ValueError) as got:
        build(panalyzers)
    assert str(got.value) == str(want.value)


def test_english_is_the_reference_chain_not_lucenes():
    """Queue 3: the reference's `english` is std -> lowercase -> stop ->
    porter; Lucene's EnglishAnalyzer also strips possessives and honours
    a keyword marker, so there `john's` indexes as `john`."""
    port = panalyzers.AnalysisRegistry().get("english")
    ref = ranalyzers.AnalysisRegistry().get("english")
    text = "John's dogs are running to the kennels"
    assert port.terms(text) == ref.terms(text) == [
        "john'", "dog", "run", "kennel"]


def test_smartcn_raises_without_jieba(monkeypatch):
    """Queue 3: the port imports jieba at smartcn's first use and raises
    naming it where it is missing; the reference falls back to
    script-run tokens."""
    text = "北京故宫博物院"
    monkeypatch.setattr(pcjk, "_JIEBA", None)
    monkeypatch.setitem(sys.modules, "jieba", None)
    ana = panalyzers.AnalysisRegistry().get("smartcn")
    with pytest.raises(ImportError, match=r"\[jieba\]"):
        ana.analyze(text)
    monkeypatch.setattr(rcjk, "_JIEBA", None)
    monkeypatch.setattr(rcjk, "_JIEBA_FAILED", False)
    assert [t.text for t in ranalyzers.AnalysisRegistry().get(
        "smartcn").analyze(text)] == [t.text for t in
                                      rcjk.kuromoji_lite_tokenizer(text)]


def test_jieba_is_imported_only_at_smartcn_first_use():
    import subprocess
    code = ("import sys; import opensearch_tpu_torch; "
            "from opensearch_tpu_torch.analysis import analyzers as a; "
            "r = a.AnalysisRegistry(); r.get('english').analyze('x'); "
            "r.get('smartcn'); assert 'jieba' not in sys.modules; "
            "r.get('smartcn').analyze('北京'); "
            "assert 'jieba' in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True)


INDEX_BODY = {
    "settings": {"number_of_replicas": 0, "analysis": {
        "char_filter": {"amp": {"type": "mapping",
                                "mappings": ["& => and"]}},
        "tokenizer": {"dash": {"type": "pattern", "pattern": "[-\\s]+"}},
        "filter": {"short": {"type": "length", "min": 2}},
        "analyzer": {"chain": {"type": "custom",
                               "char_filter": ["html_strip", "amp"],
                               "tokenizer": "dash",
                               "filter": ["lowercase", "short",
                                          "porter_stem"]}},
        "normalizer": {"fold": {"type": "custom",
                                "filter": ["lowercase", "asciifolding"]}}}},
    "mappings": {"properties": {
        "title": {"type": "text", "analyzer": "english"},
        "body": {"type": "text", "analyzer": "chain"},
        "tag": {"type": "keyword", "normalizer": "fold"},
        "coll": {"type": "icu_collation_keyword", "strength": "secondary"},
        "sayt": {"type": "search_as_you_type"}}}}


@pytest.fixture(scope="module")
def analyze_clients():
    ref = RefClient(node=Node(mesh_service=False))
    port = RestClient(device="cpu")
    for c in (ref, port):
        c.indices.create("a", copy.deepcopy(INDEX_BODY))
    return ref, port


@pytest.mark.parametrize("index,body", [
    (None, {"text": CORPUS[0]}),
    (None, {"analyzer": "english", "text": CORPUS[:3]}),
    (None, {"analyzer": "kuromoji", "text": CORPUS[5]}),
    (None, {"analyzer": "nori", "text": CORPUS[6]}),
    (None, {"analyzer": "polish", "text": CORPUS[7]}),
    (None, {"analyzer": "ukrainian", "text": CORPUS[8]}),
    (None, {"analyzer": "cjk", "text": CORPUS[4]}),
    (None, {"analyzer": "icu_analyzer", "text": CORPUS[2]}),
    ("a", {"analyzer": "chain", "text": CORPUS[3]}),
    ("a", {"field": "title", "text": CORPUS[1]}),
    ("a", {"field": "body", "text": [CORPUS[3], CORPUS[9]]}),
    ("a", {"field": "tag", "text": "Café Olé"}),
    ("a", {"field": "coll", "text": "Äpple"}),
    ("a", {"field": "sayt._2gram", "text": CORPUS[0]}),
    ("a", {"field": "sayt._index_prefix", "text": "quick fox"}),
    ("a", {"field": "unmapped", "text": CORPUS[1]}),
    ("a", {"text": CORPUS[10]}),
])
def test_indices_analyze_matches_reference(analyze_clients, index, body):
    ref, port = analyze_clients
    want = ref.indices.analyze(index, copy.deepcopy(body))
    assert port.indices.analyze(index, copy.deepcopy(body)) == want
    assert want["tokens"] or not body["text"]


@pytest.mark.parametrize("index", [None, "a"])
def test_indices_analyze_unknown_analyzer_raises_as_reference(
        analyze_clients, index):
    ref, port = analyze_clients
    with pytest.raises(ValueError) as want:
        ref.indices.analyze(index, {"analyzer": "nope", "text": "x"})
    with pytest.raises(ValueError) as got:
        port.indices.analyze(index, {"analyzer": "nope", "text": "x"})
    assert str(got.value) == str(want.value) == "unknown analyzer [nope]"
