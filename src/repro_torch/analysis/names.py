"""Vocabulary checker: the stringly-typed metric/span names stay coherent
(a copy of the JAX package's ``analysis/names.py``).

The stack's observability contract is a flat dotted namespace
(``server.*`` / ``gateway.*`` / ``cache.*`` / ``sessions.*`` / ``train.*``
/ ``lod.*``) registered via ``counter("...")``/``gauge("...")``/
``histogram("...")`` plus the span vocabularies ``STAGES``/``TRAIN_STAGES``
in each package's ``obs/trace.py``. Code, benchmarks, and the README all reference these
names as string literals — nothing type-checks them, so a typo'd read or a
renamed metric silently reports zeros. This pass extracts every name and
cross-checks:

``names.unregistered_use``
    A tier-dotted string literal used in code (a read, a doc-string example,
    a test assertion) that no registration site or declared family produces.

``names.unread``
    A registered metric whose dotted name no code outside the registration
    reads — not as an exact literal, not via a prefix read (``"gateway." +
    name``, ``stage_breakdown(snap, prefix="server.")``), and not documented
    in the scanned docs. Either wire it into a report/test/README or drop it.

``names.doc_drift``
    A tier-dotted name in the docs (README, ``bench_schema.py``) that
    matches no registered name or family — documentation that drifted from
    the registry.

``names.dynamic_unresolved``
    A registration whose name is built dynamically with no static dotted
    prefix (``gauge(f"{prefix}.bytes.{dev}")``). Declare the produced family
    at the site: ``# analysis: declare(train.devmem.*)``.

``names.unknown_span`` / ``names.unrecorded_stage``
    A ``record(rid, "<span>")`` literal outside ``STAGES``/``TRAIN_STAGES``,
    and a vocabulary stage never recorded anywhere (exporters lay Perfetto
    lanes from the vocabulary — a dead stage is a dead lane).

Dynamic registrations with a static dotted prefix (``f"server.lod_rows.l
{lvl}"``) register the family ``server.lod_rows.l*``; doc names may use
``*`` or ``<i>``-style placeholders to reference a family.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.common import Finding, SourceFile

__all__ = ["run", "extract_vocab", "TIERS"]

TIERS = ("server", "gateway", "cache", "sessions", "train", "lod")

_REG_METHODS = {"counter", "gauge", "histogram"}
_NAME_RE = re.compile(r"^(?:%s)\.[A-Za-z0-9_.]+$" % "|".join(TIERS))
_DOC_RE = re.compile(r"\b(?:%s)\.[A-Za-z0-9_.<>{}*]*[A-Za-z0-9_*>}]" % "|".join(TIERS))
_SPAN_VOCAB_NAMES = {"STAGES", "TRAIN_STAGES"}
# "sessions.py" / "train.jsonl" are file references, not metric names
_FILE_EXT_RE = re.compile(r"\.(py|pyc|md|json|jsonl|txt|yml|yaml|csv|png|npz|npy)$")


def _static_prefix(node) -> str | None:
    """Leading literal of a dynamically-built string, or None.

    Handles f-strings, ``"a." + x``, ``"a.%d" % x`` and ``"a.{}".format(x)``.
    """
    if isinstance(node, ast.JoinedStr):
        if node.values and isinstance(node.values[0], ast.Constant):
            return str(node.values[0].value)
        return ""
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Add, ast.Mod)):
        if isinstance(node.left, ast.Constant) and isinstance(node.left.value, str):
            return node.left.value.split("%")[0]
        return ""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "format"
            and isinstance(node.func.value, ast.Constant)
            and isinstance(node.func.value.value, str)):
        return node.func.value.value.split("{")[0]
    return None


class Vocab:
    """Everything extracted from the scanned tree in one walk."""

    def __init__(self):
        self.registered: dict[str, tuple[str, int]] = {}   # name -> site
        self.families: dict[str, tuple[str, int]] = {}     # prefix -> site
        self.dynamic_unresolved: list[tuple[str, int, str]] = []  # path, line, ctx
        self.uses: list[tuple[str, str, int]] = []         # name, path, line
        self.read_prefixes: set[str] = set()
        self.declared: set[str] = set()        # exact declares
        self.declared_families: set[str] = set()
        self.spans_recorded: list[tuple[str, str, int]] = []
        self.span_vocab: dict[str, tuple[str, int]] = {}   # stage -> def site

    # ---- matching helpers
    def covers(self, name: str) -> bool:
        """Is ``name`` produced by some registration or declaration?"""
        if name in self.registered or name in self.declared:
            return True
        return any(name.startswith(f)
                   for f in (*self.families, *self.declared_families))

    def doc_token_matches(self, token: str) -> bool:
        """Does a doc name (possibly with ``*``/``<i>``/``{i}`` placeholders)
        reference at least one registered name or family?"""
        norm = re.sub(r"(<[^>]*>|\{[^}]*\})", "*", token)
        if "*" not in norm:
            return self.covers(norm)
        prefix = norm.split("*", 1)[0]
        if any(n.startswith(prefix) for n in (*self.registered, *self.declared)):
            return True
        return any(f.startswith(prefix) or prefix.startswith(f)
                   for f in (*self.families, *self.declared_families))

    def read_evidence(self, name: str, reg_site: tuple[str, int]) -> bool:
        for use, path, line in self.uses:
            if use == name and (path, line) != reg_site:
                return True
        return any(name.startswith(p) for p in self.read_prefixes)


class _Extractor(ast.NodeVisitor):
    def __init__(self, sf: SourceFile, vocab: Vocab):
        self.sf = sf
        self.vocab = vocab
        self._funcs: list[str] = []
        self._reg_sites: set[tuple[int, int]] = set()  # (line, col) of reg args

    def _visit_func(self, node):
        self._funcs.append(node.name)
        self.generic_visit(node)
        self._funcs.pop()

    visit_FunctionDef = visit_AsyncFunctionDef = _visit_func

    def visit_Assign(self, node: ast.Assign):
        # STAGES / TRAIN_STAGES tuple definitions (module scope)
        if not self._funcs:
            for t in node.targets:
                if (isinstance(t, ast.Name) and t.id in _SPAN_VOCAB_NAMES
                        and isinstance(node.value, (ast.Tuple, ast.List))):
                    for el in node.value.elts:
                        if isinstance(el, ast.Constant) and isinstance(el.value, str):
                            self.vocab.span_vocab.setdefault(
                                el.value, (self.sf.relpath, el.lineno)
                            )
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        f = node.func
        attr = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None
        )
        if attr in _REG_METHODS and node.args:
            arg = node.args[0]
            site = (self.sf.relpath, node.lineno)
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                self._reg_sites.add((arg.lineno, arg.col_offset))
                if _NAME_RE.match(arg.value):
                    self.vocab.registered.setdefault(arg.value, site)
            else:
                prefix = _static_prefix(arg)
                if prefix is not None:
                    if "." in prefix and prefix.split(".", 1)[0] in TIERS:
                        self.vocab.families.setdefault(prefix, site)
                    elif not self.sf.declare_covers(node.lineno):
                        ctx = ".".join(self._funcs) or "<module>"
                        self.vocab.dynamic_unresolved.append(
                            (self.sf.relpath, node.lineno, ctx)
                        )
        elif attr in ("record", "instant") and len(node.args) >= 2:
            arg = node.args[1]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                self.vocab.spans_recorded.append(
                    (arg.value, self.sf.relpath, arg.lineno)
                )
        # prefix reads built dynamically: "gateway." + name, "%s.x" % tier
        for sub in ast.walk(node):
            p = _static_prefix(sub)
            if p and p.endswith(".") and p.rstrip(".").split(".", 1)[0] in TIERS:
                self.vocab.read_prefixes.add(p)
        self.generic_visit(node)

    def visit_Constant(self, node: ast.Constant):
        if isinstance(node.value, str):
            if (node.lineno, node.col_offset) in self._reg_sites:
                return
            v = node.value
            if _NAME_RE.match(v) and not _FILE_EXT_RE.search(v):
                self.vocab.uses.append((v, self.sf.relpath, node.lineno))
            elif v.endswith(".") and v.rstrip(".").split(".", 1)[0] in TIERS and "." in v:
                self.vocab.read_prefixes.add(v)


def extract_vocab(files: list[SourceFile]) -> Vocab:
    vocab = Vocab()
    for sf in files:
        for name in sf.declared_names():
            if name.endswith("*"):
                vocab.declared_families.add(name[:-1])
            else:
                vocab.declared.add(name)
    for sf in files:
        ex = _Extractor(sf, vocab)
        ex.visit(sf.tree)
        # second walk for bare constants: _reg_sites must be complete first
        # (visit_Call runs before the registration arg's own visit_Constant,
        # so one walk suffices — kept as a single pass)
    return vocab


def _doc_findings(vocab: Vocab, doc_texts: dict[str, str]) -> list[Finding]:
    out = []
    for path, text in sorted(doc_texts.items()):
        for i, line in enumerate(text.splitlines(), start=1):
            for m in _DOC_RE.finditer(line):
                token = m.group(0)
                if "." not in token or _FILE_EXT_RE.search(token):
                    continue
                if not vocab.doc_token_matches(token):
                    out.append(Finding(
                        "names.doc_drift", path, i, token,
                        f"{token!r} is documented but matches no registered "
                        "metric name or family — fix the doc or register "
                        "the name",
                    ))
    return out


def run(files: list[SourceFile], doc_texts: dict[str, str] | None = None) -> list[Finding]:
    vocab = extract_vocab(files)
    by_path = {sf.relpath: sf for sf in files}
    findings: list[Finding] = []

    for path, line, ctx in vocab.dynamic_unresolved:
        findings.append(Finding(
            "names.dynamic_unresolved", path, line, ctx,
            f"metric registered in {ctx} with a dynamically-built name the "
            "checker cannot resolve — add '# analysis: declare(<family>*)' "
            "naming the produced family",
        ))
    for use, path, line in vocab.uses:
        if vocab.covers(use):
            continue
        # a literal that is a strict prefix of registered names/families is a
        # filter read (``name.startswith("train.shard_")``), not a typo — it
        # also counts as read evidence for everything it covers
        if any(n.startswith(use) for n in
               (*vocab.registered, *vocab.declared,
                *vocab.families, *vocab.declared_families)):
            vocab.read_prefixes.add(use)
            continue
        findings.append(Finding(
            "names.unregistered_use", path, line, use,
            f"{use!r} is used here but never registered on any metrics "
            "registry — typo'd read, or a metric that was renamed",
        ))
    for name, site in sorted(vocab.registered.items()):
        if vocab.read_evidence(name, site):
            continue
        findings.append(Finding(
            "names.unread", site[0], site[1], name,
            f"{name!r} is registered but nothing reads it by name (no "
            "literal, no covering prefix read, no doc mention) — wire it "
            "into a report/doc or drop it",
        ))
    if vocab.span_vocab:
        for span, path, line in vocab.spans_recorded:
            if span not in vocab.span_vocab:
                # tests/benchmarks may record off-vocabulary spans on purpose
                # (overflow-lane coverage); only src recordings are held to
                # the vocabulary
                if path.startswith(("tests/", "benchmarks/")):
                    continue
                findings.append(Finding(
                    "names.unknown_span", path, line, span,
                    f"span {span!r} is recorded but absent from STAGES/"
                    "TRAIN_STAGES — exporters lay lanes from the vocabulary, "
                    "so this span lands in the overflow lane",
                ))
        recorded = {s for s, _, _ in vocab.spans_recorded}
        if recorded:  # only meaningful when the scanned tree records spans
            for stage, (path, line) in sorted(vocab.span_vocab.items()):
                if stage not in recorded:
                    findings.append(Finding(
                        "names.unrecorded_stage", path, line, stage,
                        f"stage {stage!r} is in the span vocabulary but never "
                        "recorded anywhere in the scanned tree — dead lane",
                    ))
    # doc evidence also counts as "read": drop unread findings whose name a
    # doc token references, then add the doc-drift findings
    doc_texts = doc_texts or {}
    if doc_texts:
        doc_tokens = set()
        for text in doc_texts.values():
            doc_tokens.update(m.group(0) for m in _DOC_RE.finditer(text)
                              if not _FILE_EXT_RE.search(m.group(0)))
        norm = [re.sub(r"(<[^>]*>|\{[^}]*\})", "*", t) for t in doc_tokens]
        def documented(name: str) -> bool:
            for t in norm:
                if t == name:
                    return True
                if "*" in t and name.startswith(t.split("*", 1)[0]):
                    return True
            return False
        findings = [f for f in findings
                    if not (f.rule == "names.unread" and documented(f.detail))]
        findings.extend(_doc_findings(vocab, doc_texts))

    # apply pragmas for findings that live in parsed python files
    out: list[Finding] = []
    for f in findings:
        sf = by_path.get(f.path)
        if sf is not None:
            sf.apply_pragmas([f])
        out.append(f)
    return out
