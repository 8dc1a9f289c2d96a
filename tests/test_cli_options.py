"""CLI long-option parity audit.

Extracts every getopt long-option name from the reference's per-subcommand
option tables (Phasing.cpp:57-85, Haplotag.cpp option definer,
SomaticHaplotag.cpp:40-130, PurityEstimation.cpp, ModCall.cpp:42-57) and
asserts the repo CLI accepts each one, so reference-written scripts keep
working verbatim (--methylbamfile class of bug).
"""

import os
import re

import pytest

from longphase_s_jax.cli import build_parser

REF_SRC = "/root/reference/src"

# subcommand -> reference source files whose long-option tables feed it
# (somatic_haplotag/estimate_purity inherit the haplotag option definer
# through ArgumentTemManager: SomaticHaplotag.h:1, PurityEstimation.h:1)
SUBCOMMAND_SOURCES = {
    "phase": ["phase/Phasing.cpp"],
    "haplotag": ["haplotag/Haplotag.cpp"],
    "somatic_haplotag": ["haplotag/Haplotag.cpp",
                         "somatic_haplotag/SomaticHaplotag.cpp"],
    "estimate_purity": ["haplotag/Haplotag.cpp",
                        "somatic_haplotag/SomaticHaplotag.cpp",
                        "somatic_haplotag/PurityEstimation.cpp"],
    "modcall": ["modcall/ModCall.cpp"],
}

OPT_RE = re.compile(r'\{\s*"([a-zA-Z0-9_-]+)",\s*(?:no|required|optional)_argument')


def _reference_long_options(files):
    names = set()
    for rel in files:
        with open(os.path.join(REF_SRC, rel)) as fh:
            names.update(OPT_RE.findall(fh.read()))
    return names


@pytest.mark.skipif(not os.path.isdir(REF_SRC), reason="reference not present")
@pytest.mark.parametrize("subcommand", sorted(SUBCOMMAND_SOURCES))
def test_reference_long_options_accepted(subcommand):
    parser = build_parser()
    sub_actions = parser._subparsers._group_actions[0].choices
    ours = set()
    for opt in sub_actions[subcommand]._option_string_actions:
        if opt.startswith("--"):
            ours.add(opt[2:])
    ref = _reference_long_options(SUBCOMMAND_SOURCES[subcommand])
    # "version" exists only at the top level for subcommands that route it
    # there; "help" is argparse-native. Everything else must match.
    missing = ref - ours
    assert not missing, f"{subcommand}: reference long options missing: {sorted(missing)}"


@pytest.mark.skipif(not os.path.isdir(REF_SRC), reason="reference not present")
def test_reference_short_options_accepted():
    """Every short option letter in the reference shortopts strings must be
    accepted by the matching subparser (e.g. modcall -i noiseRatio)."""
    shortopt_re = re.compile(r'shortopts\s*=\s*"([^"]+)"')
    parser = build_parser()
    sub_actions = parser._subparsers._group_actions[0].choices
    for subcommand, files in SUBCOMMAND_SOURCES.items():
        letters = set()
        for rel in files:
            with open(os.path.join(REF_SRC, rel)) as fh:
                for m in shortopt_re.finditer(fh.read()):
                    letters.update(c for c in m.group(1) if c not in ":+-")
        ours = {opt[1] for opt in sub_actions[subcommand]._option_string_actions
                if len(opt) == 2 and opt[0] == "-"}
        missing = letters - ours
        assert not missing, f"{subcommand}: short options missing: {sorted(missing)}"
