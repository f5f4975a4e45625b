"""The port's AES core stays gather-free: a source guard that runs on the
CPU.

Every CUDA kernel of the port reaches AES through
`libjitsi_tpu_torch/csrc/aes.cuh`, a Boolean circuit on registers, so no
load has an address that depends on key or state bytes (the property
the JAX package's bitsliced cores were built for).  A table lookup needs
a table, so the guard fails if `aes.cuh` declares any array or pointer
other than the state and round keys its functions take, any `__device__`
/ `__constant__` / `__shared__` / `static` variable, or an initialiser
list; and if any source under `csrc/` still names the T-table core that
the circuit replaced, or if a subscript in `aes.cuh` names anything but
a loop counter, the round or a compile-time constant (names kept apart
from every state and key name; planted lookups must be refused).  Kernel
H's instances (`srtp_fanout_{cm,f8,null}` in `srtp_fanout.cu`) reach AES
only through the tile's keystream stage, which runs the core, and hold
no table of their own.  On
the card, `chip_smoke.py`'s `sass` phase checks the built kernel A for
shared memory and shared or indexed constant loads, and the core as the
tile kernels run it for loads other than its round keys.  The S-box
circuit's gate count is held against the JAX package's two circuits.
"""

import collections
import os
import re

import pytest

from libjitsi_tpu.kernels import aes_bitsliced
from libjitsi_tpu_torch.kernels import build as kbuild

AES_CUH = os.path.join(kbuild.CSRC_DIR, "aes.cuh")

# parameter and member names of aes.cuh: the state (two blocks' column
# words, their sliced form, a counter block) and round keys (column
# words, sliced words, pointers to sliced keys)
STATE = {"q", "x", "s", "a", "b", "c", "iv"}
ROUND_KEYS = {"w", "wa", "wb", "k", "ka", "kb"}
# what a subscript may name: loop counters, the round, a slot, the
# template's rotation; none is a name of the state or of a key, so a
# subscript that reads a state or key value fails the guard
INDEX_NAMES = {"i", "j", "r", "round", "slot", "K"}


def _code(path: str) -> str:
    """The source with comments and string literals blanked."""
    with open(path) as f:
        src = f.read()
    src = re.sub(r"//[^\n]*", "", src)
    src = re.sub(r"/\*.*?\*/", "", src, flags=re.S)
    return re.sub(r'"(?:\\.|[^"\\])*"', '""', src)


def _depths(code: str):
    """Parenthesis depth at each character."""
    out, d = [], 0
    for ch in code:
        if ch == "(":
            d += 1
        elif ch == ")":
            d -= 1
        out.append(d)
    return out


def _subscripts(code: str):
    """The whole text between each `[` and its matching `]`, nested
    subscripts included."""
    out, opened = [], []
    for i, ch in enumerate(code):
        if ch == "[":
            opened.append(i)
        elif ch == "]":
            out.append(code[opened.pop() + 1:i])
    return out


def _declared(code: str):
    """(name, kind, paren depth) of every array or pointer declarator:
    `type name[...]` and `type* name`."""
    depth = _depths(code)
    ty = r"(?:u?int(?:8|16|32|64)_t|int|unsigned|char|long|uint4|short)"
    found = []
    for m in re.finditer(ty + r"\s+(?:const\s+)?(\w+)\s*\[", code):
        found.append((m.group(1), "array", depth[m.start()]))
    for m in re.finditer(ty + r"\s*(?:const\s*)?\*\s*(?:const\s+)?"
                         r"(?:__restrict__\s+)?(\w+)", code):
        found.append((m.group(1), "pointer", depth[m.start()]))
    return found


def _table_faults(code: str):
    """What in `code` (aes.cuh, comments blanked) could hold or read a
    table: an array or pointer it declares, a storage keyword, an
    initialiser list, a subscript by a state or key value."""
    faults = []
    decls = _declared(code)
    if not decls:
        faults.append("no parameters found: the guard's parser broke")
    faults += [f"array {n}" for n, k, d in decls
               if d == 0 and k == "array"]      # a variable, not a parameter
    faults += [f"{k} {n}" for n, k, _d in decls
               if n not in STATE | ROUND_KEYS]
    for word in ("__constant__", "__shared__", "static", "__ldg",
                 "tex1D", "tex2D", "texture"):
        if re.search(r"\b" + word + r"\b(?!_assert)", code):
            faults.append(word)
    # a __device__ variable (not a function): `__device__ [const] T name`
    # followed by `=`, `[` or `;`
    if re.search(r"__device__\s+(?:const\s+)?\w+\s+\w+\s*[=\[;]", code):
        faults.append("__device__ variable")
    # an initialiser list of constants (a table written out)
    if re.search(r"\{\s*0x[0-9a-fA-F]+\s*,", code):
        faults.append("initialiser list")
    # every subscript is a loop counter, the round, a compile-time
    # parameter or a constant, never a value of the state or a key
    for sub in _subscripts(code):
        if not set(re.findall(r"[A-Za-z_]\w*", sub)) <= INDEX_NAMES:
            faults.append(f"subscript [{sub}]")
    return faults


def test_aes_core_declares_no_table():
    assert _table_faults(_code(AES_CUH)) == []


# Lines the guard must refuse, each planted into the real aes.cuh: a
# read of a round key at a state byte, a state word at a key byte, a
# table under each storage kind, and a pointer that is not state or key.
PLANTED = [
    "__device__ uint32_t ljt_leak(const uint32_t k[8], const uint32_t q[8])"
    " { return k[q[0] & 7]; }",
    "__device__ uint32_t ljt_leak(uint32_t x[8], const uint32_t w[4])"
    " { return x[w[1] >> 29]; }",
    "__device__ uint32_t ljt_leak(uint32_t s[8], int i)"
    " { return s[s[i] & 7]; }",
    "__shared__ uint32_t ljt_t[256];",
    "__constant__ uint8_t ljt_sb[256] = {0x63, 0x7c};",
    "__device__ uint32_t ljt_leak(int j) { uint32_t t[4]; t[0] = j;"
    " return t[j & 3]; }",
    "__device__ uint32_t ljt_leak(const uint32_t* te, uint32_t x)"
    " { return x; }",
]


@pytest.mark.parametrize("line", PLANTED)
def test_guard_refuses_a_planted_table(line):
    code = _code(AES_CUH)
    tail = code.rindex("}")
    assert _table_faults(code[:tail + 1] + "\n" + line + "\n")


def test_no_source_reaches_a_t_table():
    names = sorted(n for n in os.listdir(kbuild.CSRC_DIR)
                   if n.endswith((".cu", ".cuh")))
    assert "aes.cuh" in names and "warp_row.cuh" not in names
    gone = re.compile(r"kLjtSbox|ljt_aes_fill_te0|LjtTe0Share|kTeWords|"
                      r"\bte0\b|(?:\.|->)te\b|\bte\s*;|"
                      r"ljt_aes_encrypt_block\b|ljt_te0_from_sbox")
    hits = []
    for n in names:
        for i, line in enumerate(_code(os.path.join(kbuild.CSRC_DIR, n))
                                 .splitlines(), 1):
            if gone.search(line):
                hits.append(f"{n}:{i}: {line.strip()}")
    assert not hits, "\n".join(hits)


@pytest.mark.parametrize("cipher", ["cm", "f8", "null"])
def test_fanout_instances_reach_aes_only_through_the_core(cipher):
    """Kernel H's instance for `cipher` is a kernel of its own whose
    keystream stage is the tile's (`keystream_tile`, over `ctr_tile` or
    `f8_tile` and the core's `ljt_aes_encrypt_pair`; none for NULL); the
    source declares no table, constant or static shared memory and names
    no AES routine but through that stage."""
    code = _code(os.path.join(kbuild.CSRC_DIR, "srtp_fanout.cu"))
    kind = {"cm": "kCm", "f8": "kF8", "null": "kNull"}[cipher]
    m = re.search(r"srtp_fanout_" + cipher + r"_kernel\([^{]*\{\s*"
                  r"srtp_fanout_tile<NR,\s*" + kind + r">", code, re.S)
    assert m, f"no {cipher} instance of kernel H"
    assert re.search(r"keystream_tile<NR,\s*C>", code)
    for word in ("ljt_aes_encrypt_pair", "ctr_tile", "f8_tile",
                 "__constant__", "static __shared__", "__ldg"):
        assert word not in code, word
    assert not re.search(r"\{\s*0x[0-9a-fA-F]+\s*,", code)
    assert not re.search(r"__device__\s+(?:const\s+)?\w+\s+\w+\s*[=\[;]",
                         code)


class _Gate:
    """A bit-plane stand-in that counts the gates a circuit applies."""

    counts = collections.Counter()

    def _op(self, kind):
        _Gate.counts[kind] += 1
        return _Gate()

    def __and__(self, other):
        return self._op("and")

    def __xor__(self, other):
        return self._op("xor")

    def __or__(self, other):
        return self._op("or")

    def __invert__(self):
        return self._op("not")

    __rand__, __rxor__, __ror__ = __and__, __xor__, __or__


def _gates_of_jax(circuit) -> int:
    _Gate.counts.clear()
    circuit([_Gate() for _ in range(8)], ones=1)
    return sum(_Gate.counts.values())


def _gates_of_port():
    code = _code(AES_CUH)
    m = re.search(r"void ljt_aes_sbox\(uint32_t q\[8\]\) \{(.*?)\n\}", code,
                  re.S)
    assert m, "ljt_aes_sbox not found"
    body = m.group(1)
    return (len(re.findall(r"(?<![&])&(?![&=])", body)),
            len(re.findall(r"\^(?!=)", body)),
            len(re.findall(r"\|(?![|=])", body)))


@pytest.mark.parametrize("circuit,gates", [
    (aes_bitsliced._sbox_bits, 660),
    (aes_bitsliced._sbox_bits_tower, 249),
])
def test_sbox_circuit_is_the_smallest(circuit, gates):
    """The port's S-box is Boyar and Peralta's circuit: 32 AND and 83
    XOR/XNOR (an XNOR is `^ ~`), no OR; the JAX package's addition-chain
    and tower-field circuits apply more gates per S-box."""
    ands, xors, ors = _gates_of_port()
    assert (ands, xors, ors) == (32, 83, 0)
    assert _gates_of_jax(circuit) == gates > ands + xors
