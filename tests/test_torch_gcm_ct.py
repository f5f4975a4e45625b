"""The port's GHASH stays constant-time: a source guard that runs on the
CPU, as `test_torch_aes_ct.py` is for the AES core.

`libjitsi_tpu_torch/csrc/ghash.cuh` multiplies in GF(2^128) with the hash
key's bit matrix held in a warp's registers (popcounts and ballots), so
no load address and no branch depends on H, the key, the GHASH state or
the data.  The usual fast software GHASH, Shoup's 4-bit or 8-bit table
method, indexes a table derived from H by state bits; a table needs an
array and a state-indexed read, so the guard fails if `ghash.cuh`
declares any array, any `__shared__` / `__constant__` / `static` /
`__device__` variable or an initialiser list, takes a pointer other
than the matrix, holds any branch or loop (`if`, `for`, `while`, `?`,
`switch`, `&&`, `||`), takes a subscript by anything but the lane, or
shuffles from a lane named by anything but the lane.
The GCM kernels (`gcm_tile.cuh`, `srtp_gcm.cu`, `gcm_fill.cu` and H's
GCM instance in `srtp_fanout.cu`) may branch and index on lengths,
offsets, slots, rows, lanes and counts, which are public, but no
subscript (the staged GHASH input's block included), no condition and no
warp shuffle's source lane there names a value of the state, the key, H
or the data.  Planted Shoup-table lookups and shuffles indexed by a
secret are refused.  On the card, `chip_smoke.py`'s
`sass` phase checks the built kernels for indexed constant loads,
local memory at a computed address and memory loads inside the GHASH
chain.
"""

import os
import re

import pytest

from libjitsi_tpu_torch.kernels import build as kbuild

from test_torch_aes_ct import _code, _declared, _subscripts

GHASH_CUH = os.path.join(kbuild.CSRC_DIR, "ghash.cuh")
GCM_SOURCES = ("gcm_tile.cuh", "srtp_gcm.cu", "gcm_fill.cu")

# the only subscript ghash.cuh may take: a lane's matrix rows
GHASH_INDEX = {"lane"}
# names the GCM sources give values of the GHASH state (ghy), the matrix
# rows of H (ghm), the tag and tag mask (tag, tagb, ekr), the AES pair's
# blocks and sliced state (a, b, s), loaded round keys (kv, key), words
# and bytes of the data (w0, w1, v, bytes) and the keystream blocks they
# store (ks4, ek4)
SECRET = {"ghy", "ghm", "tag", "tagb", "ekr", "a", "b", "s", "kv", "key",
          "w0", "w1", "v", "bytes", "ks4", "ek4"}


def _ghash_faults(code: str):
    """What in ghash.cuh (comments blanked) could hold or read a table or
    branch: an array or a pointer other than the matrix, a storage
    keyword, an initialiser list, a branch or loop, a subscript by
    anything but the lane."""
    faults = []
    decls = _declared(code)
    faults += [f"array {n}" for n, k, _d in decls if k == "array"]
    faults += [f"pointer {n}" for n, k, _d in decls
               if k == "pointer" and n != "gm"]
    if not re.search(r"const\s+uint4\s*\*\s*gm", code):
        faults.append("no matrix parameter found: the guard's parser broke")
    for word in ("__constant__", "__shared__", "static", "__ldg", "tex1D",
                 "texture", "if", "for", "while", "switch", "goto"):
        if re.search(r"\b" + word + r"\b", code):
            faults.append(word)
    for op in ("?", "&&", "||"):
        if op in code:
            faults.append(op)
    if re.search(r"__device__\s+(?:const\s+)?\w+\s+\w+\s*[=\[;]", code):
        faults.append("__device__ variable")
    if re.search(r"\{\s*0x[0-9a-fA-F]+\s*,", code):
        faults.append("initialiser list")
    for sub in _subscripts(code):
        if not set(re.findall(r"[A-Za-z_]\w*", sub)) <= GHASH_INDEX:
            faults.append(f"subscript [{sub}]")
    return faults


def _conditions(code: str):
    """The condition of every `if`, `while`, `for` and `switch`, and the
    text before each `?` back to the start of its expression."""
    out = []
    for m in re.finditer(r"\b(if|while|for|switch)\s*\(", code):
        depth, i = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(code[i], 0)
            i += 1
        out.append(code[m.end():i - 1])
    for m in re.finditer(r"\?", code):
        start = max(code.rfind(c, 0, m.start()) for c in "=(,;{:")
        out.append(code[start + 1:m.start()])
    return out


def _secret_faults(code: str):
    """Subscripts and conditions of GCM kernel code that name a value of
    the state, the key, H or the data."""
    faults = []
    for sub in _subscripts(code):
        hit = set(re.findall(r"[A-Za-z_]\w*", sub)) & SECRET
        if hit:
            faults.append(f"subscript [{sub}] names {sorted(hit)}")
    for cond in _conditions(code):
        hit = set(re.findall(r"(?<![.\w])[A-Za-z_]\w*", cond)) & SECRET
        if hit:
            faults.append(f"condition ({cond.strip()}) names {sorted(hit)}")
    return faults


def _call_args(code: str, fn: str):
    """The argument list of every call of `fn` in `code`, split at its
    top-level commas."""
    out = []
    for m in re.finditer(r"\b" + fn + r"\s*\(", code):
        depth, i, args, start = 1, m.end(), [], m.end()
        while depth:
            ch = code[i]
            if ch in "([{":
                depth += 1
            elif ch in ")]}":
                depth -= 1
            elif ch == "," and depth == 1:
                args.append(code[start:i])
                start = i + 1
            i += 1
        args.append(code[start:i - 1])
        out.append([a.strip() for a in args])
    return out


def _shuffle_faults(code: str, allowed=None):
    """Warp shuffles whose source lane (or lane mask, or delta: the third
    argument) names a value of the state, the key, H or the data, or,
    given `allowed`, any name outside it: a shuffle indexed by a secret
    is a lookup into the warp's registers."""
    faults = []
    for fn in ("__shfl_sync", "__shfl_up_sync", "__shfl_down_sync",
               "__shfl_xor_sync"):
        for args in _call_args(code, fn):
            names = set(re.findall(r"(?<![.\w])[A-Za-z_]\w*",
                                   args[2] if len(args) > 2 else ""))
            bad = names & SECRET if allowed is None else names - allowed
            if len(args) < 3 or bad:
                faults.append(f"{fn}({', '.join(args)}) names "
                              f"{sorted(bad) or 'no lane'}")
    return faults


def _fanout_gcm_code() -> str:
    """H's GCM instance in srtp_fanout.cu: its row policy and kernel."""
    code = _code(os.path.join(kbuild.CSRC_DIR, "srtp_fanout.cu"))
    start = code.index("struct FanoutGcmRows")
    end = code.index("extern \"\"", start) if "extern \"\"" in code[start:] \
        else code.index("ljt_srtp_fanout_cm", start)
    return code[start:end]


def test_ghash_core_is_table_free_and_branch_free():
    code = _code(GHASH_CUH)
    assert _ghash_faults(code) == []
    assert _shuffle_faults(code, allowed=GHASH_INDEX) == []


@pytest.mark.parametrize("name", GCM_SOURCES)
def test_gcm_kernels_index_and_branch_on_public_values_only(name):
    code = _code(os.path.join(kbuild.CSRC_DIR, name))
    assert _subscripts(code) and _conditions(code), "the parser broke"
    assert _secret_faults(code) == []
    assert _shuffle_faults(code) == []


def test_fanout_gcm_instance_indexes_and_branches_on_public_values_only():
    code = _fanout_gcm_code()
    assert "gcm_tile<NR, false, false>" in code.replace("ljt_gcm::", "")
    assert _secret_faults(code) == []
    assert _shuffle_faults(code) == []


# Shoup-style lookups and tables the guard must refuse, each planted into
# the real ghash.cuh: a 4-bit table of multiples of H read by a state
# nibble, the reduction table as a constant array, a shared table, a
# byte-wide table walked in a loop, a branch on a state bit, a pointer to
# a table that is not the matrix.
PLANTED_GHASH = [
    "__device__ uint4 ljt_leak(const uint4* gm, uint4 y)"
    " { return gm[y.x >> 28]; }",
    "__constant__ uint32_t ljt_r4[16] = {0x0000, 0x1c20, 0x3840};",
    "__shared__ uint4 ljt_m4[16];",
    "__device__ uint4 ljt_leak(const uint4* gm, uint4 y) { uint4 z = y;"
    " for (int i = 0; i < 32; ++i) z = gm[(y.x >> (4 * i)) & 15];"
    " return z; }",
    "__device__ uint4 ljt_leak(uint4 y)"
    " { if (y.w & 1) y.x ^= 0xE1000000u; return y; }",
    "__device__ uint4 ljt_leak(const uint4* m8, int lane)"
    " { return m8[lane]; }",
    "__device__ uint4 ljt_leak(uint4 y) { return y.w & 1 ? y : y; }",
]


@pytest.mark.parametrize("line", PLANTED_GHASH)
def test_ghash_guard_refuses_a_planted_table(line):
    code = _code(GHASH_CUH)
    tail = code.rindex("}")
    assert _ghash_faults(code[:tail + 1] + "\n" + line + "\n")


# the same kind of lookups planted into the GCM tile: a table read by the
# GHASH state or by data bytes, and a branch on a tag byte
PLANTED_TILE = [
    "__device__ uint4 ljt_leak(const uint4* tbl, uint4 ghy)"
    " { return tbl[ghy.x & 15]; }",
    "__device__ uint32_t ljt_leak(const uint32_t* tbl, uint32_t w0)"
    " { return tbl[w0 >> 24]; }",
    "__device__ int ljt_leak(uint32_t tagb) { if (tagb == 0) return 1;"
    " return 0; }",
    "__device__ uint32_t ljt_leak(uint4 ghm, int k)"
    " { return ghm.x > 7 ? k : 0; }",
]


@pytest.mark.parametrize("line", PLANTED_TILE)
def test_gcm_guard_refuses_a_planted_lookup(line):
    code = _code(os.path.join(kbuild.CSRC_DIR, "gcm_tile.cuh"))
    assert _secret_faults(code + "\n" + line + "\n")


# shuffles and staged-input reads the guard must refuse, planted into the
# GCM tile: a block broadcast from a lane named by a state word, by a
# data word and by the tag, a butterfly by a matrix word, and the staged
# GHASH input read at a block named by the state
PLANTED_SHUFFLE = [
    "__device__ uint32_t ljt_leak(uint32_t x, uint4 ghy)"
    " { return __shfl_sync(0xFFFFFFFFu, x, ghy.x & 31); }",
    "__device__ uint32_t ljt_leak(uint32_t x, uint32_t v)"
    " { return __shfl_sync(0xFFFFFFFFu, x, int(v >> 27), 32); }",
    "__device__ uint32_t ljt_leak(uint32_t x, uint32_t tagb)"
    " { return __shfl_down_sync(0xFFFFFFFFu, x, tagb & 7); }",
    "__device__ uint32_t ljt_leak(uint32_t x, uint4 ghm)"
    " { return __shfl_xor_sync(0xFFFFFFFFu, x, ghm.y & 16); }",
]


@pytest.mark.parametrize("line", PLANTED_SHUFFLE)
def test_gcm_guard_refuses_a_planted_shuffle(line):
    code = _code(os.path.join(kbuild.CSRC_DIR, "gcm_tile.cuh"))
    assert _shuffle_faults(code + "\n" + line + "\n")
    # in ghash.cuh a shuffle may name the lane alone
    ghash = _code(GHASH_CUH)
    assert _shuffle_faults(ghash + "\n" + line + "\n",
                           allowed=GHASH_INDEX)


def test_gcm_guard_refuses_a_staged_input_read_by_the_state():
    code = _code(os.path.join(kbuild.CSRC_DIR, "gcm_tile.cuh"))
    line = ("__device__ uint4 ljt_leak(const uint4* gs, uint4 ghy)"
            " { return gs[ghy.w & 7]; }")
    assert _secret_faults(code + "\n" + line + "\n")
    # a shuffle by the lane alone passes both checks
    fine = ("__device__ uint32_t ljt_ok(uint32_t x, int lane)"
            " { return __shfl_sync(0xFFFFFFFFu, x, lane & 3); }")
    assert not _shuffle_faults(code + "\n" + fine + "\n")
    assert not _shuffle_faults(_code(GHASH_CUH) + "\n" + fine + "\n",
                               allowed=GHASH_INDEX)
