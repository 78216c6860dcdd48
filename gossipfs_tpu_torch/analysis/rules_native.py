"""Cross-language obs ownership: the native engine's kind strings.

The port's ``native.py`` builds the C++ epoll engine of ``native/`` and
renders its buffered event lines through the port's ``FlightRecorder``;
``gfs_vitals`` serves the uniform-vitals text.  The port's schema
(``obs/schema.py``) must own every kind across the language boundary: a
kind string minted in C++ that ``EVENT_KINDS`` does not know would write
streams ``obs.recorder.load_stream`` drops rows from, and a vitals field
outside ``VITALS_FIELDS`` would bypass the n/a-not-0 rendering.

A text scan over the one engine source (the JAX package's
``native-obs-kinds``, reading the port's schema): every ``ObsEmit("<kind>"``
literal must be an ``EVENT_KINDS`` key and every ``AppendVital(os,
"<field>"`` literal a ``VITALS_FIELDS`` member.  The rule also fails if it
finds no sites at all (the extractor drifted from the emission idiom).
"""

from __future__ import annotations

import re

from gossipfs_tpu_torch.analysis.framework import (
    Finding,
    RepoIndex,
    line_of,
    module_literal,
    rule,
)

_ENGINE = "native/engine.cc"
_SCHEMA = "gossipfs_tpu_torch/obs/schema.py"

# ObsEmit("<kind>", ...) — both the (kind, observer, subject, detail)
# and the (kind, observer, subject_addr, detail) overloads
_OBS_RE = re.compile(r'ObsEmit\(\s*"([a-z_]+)"')
# AppendVital(os, "<field>", ...)
_VITAL_RE = re.compile(r'AppendVital\([^,()]*,\s*"([a-z_]+)"')


@rule(
    "native-obs-kinds",
    "every event-kind string literal the native engine emits "
    "(ObsEmit sites in native/engine.cc) must be an obs.schema "
    "EVENT_KINDS kind, and every gfs_vitals field (AppendVital sites) "
    "a VITALS_FIELDS member — schema ownership enforced across the "
    "language boundary",
    fixture="lint/native_obs_kinds.cc",
    fixture_at="native/engine.cc",
)
def check_native_obs_kinds(index: RepoIndex) -> list[Finding]:
    out: list[Finding] = []
    tree = index.tree(_SCHEMA)
    kinds = module_literal(tree, "EVENT_KINDS")
    vitals = module_literal(tree, "VITALS_FIELDS")
    if kinds is None:
        out.append(Finding(
            "native-obs-kinds", _SCHEMA, 1,
            "EVENT_KINDS is no longer a literal dict — the native "
            "kind-ownership rule cannot statically read it"))
        kinds = {}
    if vitals is None:
        out.append(Finding(
            "native-obs-kinds", _SCHEMA, 1,
            "VITALS_FIELDS is no longer a literal tuple — the native "
            "vitals-ownership rule cannot statically read it"))
        vitals = ()
    if not index.exists(_ENGINE):
        out.append(Finding(
            "native-obs-kinds", _ENGINE, 1,
            "native/engine.cc not found — the native obs rule went "
            "blind"))
        return out
    src = index.source(_ENGINE)
    obs_sites = list(_OBS_RE.finditer(src))
    vital_sites = list(_VITAL_RE.finditer(src))
    if not obs_sites or not vital_sites:
        out.append(Finding(
            "native-obs-kinds", _ENGINE, 1,
            "no ObsEmit/AppendVital sites found (the extractor drifted "
            "from the engine's emission idiom?)"))
    for m in obs_sites:
        if m.group(1) not in kinds:
            out.append(Finding(
                "native-obs-kinds", _ENGINE, line_of(src, m.start()),
                f"native engine emits kind {m.group(1)!r} which is not "
                "an obs.schema.EVENT_KINDS kind — streams would "
                "silently drop these rows at load_stream"))
    vital_set = set(vitals if isinstance(vitals, (tuple, list)) else ())
    for m in vital_sites:
        if m.group(1) not in vital_set:
            out.append(Finding(
                "native-obs-kinds", _ENGINE, line_of(src, m.start()),
                f"gfs_vitals serves field {m.group(1)!r} which is not "
                "in obs.schema.VITALS_FIELDS — the uniform-vitals "
                "surface would drift from the schema"))
    return out
