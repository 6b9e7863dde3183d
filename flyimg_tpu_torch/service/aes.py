"""AES-256 in CBC mode, in plain Python (FIPS-197, SP 800-38A).

Signed URLs (``service/security.py``) need AES-256-CBC to stay
wire-compatible with the reference's tokens. The port carries its own
cipher instead of importing ``cryptography``, which the card machine does
not have. It is table-driven (the four round T-tables of each direction,
built at import from the S-box), pads nothing (the caller pads) and works
on whole 16-byte blocks. A token of a few hundred bytes takes tens of
microseconds a block; it guards no secret at rest, and the timing of a
pure-Python cipher is not constant.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

__all__ = ["cbc_encrypt", "cbc_decrypt", "BLOCK"]

BLOCK = 16
_ROUNDS = 14        # AES-256
_KEY_WORDS = 8


def _rotl8(x: int, shift: int) -> int:
    return ((x << shift) | (x >> (8 - shift))) & 0xFF


def _gmul(a: int, b: int) -> int:
    """Multiplication in GF(2^8) modulo x^8 + x^4 + x^3 + x + 1."""
    out = 0
    while b:
        if b & 1:
            out ^= a
        a <<= 1
        if a & 0x100:
            a ^= 0x11B
        b >>= 1
    return out


def _sboxes() -> Tuple[List[int], List[int]]:
    """The S-box and its inverse: the multiplicative inverse in GF(2^8)
    through the affine map (walking the field by the generator 3)."""
    sbox = [0] * 256
    p = q = 1
    while True:
        # p *= 3, q /= 3
        p = p ^ ((p << 1) & 0xFF) ^ (0x1B if p & 0x80 else 0)
        q ^= q << 1
        q ^= q << 2
        q ^= q << 4
        q &= 0xFF
        if q & 0x80:
            q ^= 0x09
        sbox[p] = (q ^ _rotl8(q, 1) ^ _rotl8(q, 2) ^ _rotl8(q, 3)
                   ^ _rotl8(q, 4) ^ 0x63)
        if p == 1:
            break
    sbox[0] = 0x63
    inv = [0] * 256
    for i, s in enumerate(sbox):
        inv[s] = i
    return sbox, inv


_SBOX, _INV_SBOX = _sboxes()


def _ror(word: int, bits: int) -> int:
    return ((word >> bits) | (word << (32 - bits))) & 0xFFFFFFFF


def _tables(coefs, box) -> Tuple[List[int], ...]:
    t0 = []
    for x in range(256):
        s = box[x]
        a, b, c, d = (_gmul(s, k) for k in coefs)
        t0.append((a << 24) | (b << 16) | (c << 8) | d)
    return (t0, [_ror(w, 8) for w in t0], [_ror(w, 16) for w in t0],
            [_ror(w, 24) for w in t0])


# encryption tables: SubBytes then MixColumns (2 1 1 3); decryption:
# InvSubBytes then InvMixColumns (14 9 13 11)
_TE = _tables((2, 1, 1, 3), _SBOX)
_TD = _tables((14, 9, 13, 11), _INV_SBOX)


def _sub_word(w: int) -> int:
    return ((_SBOX[w >> 24] << 24) | (_SBOX[(w >> 16) & 0xFF] << 16)
            | (_SBOX[(w >> 8) & 0xFF] << 8) | _SBOX[w & 0xFF])


@lru_cache(maxsize=16)
def _expand(key: bytes) -> Tuple[List[int], List[int]]:
    """The encryption round keys (60 words) and the equivalent inverse
    cipher's (reversed, InvMixColumns applied to the middle rounds); a
    server has one key, so its schedule is cached (read only)."""
    if len(key) != 32:
        raise ValueError(f"AES-256 takes a 32-byte key, got {len(key)}")
    w = [int.from_bytes(key[4 * i:4 * i + 4], "big") for i in range(_KEY_WORDS)]
    rcon = 1
    for i in range(_KEY_WORDS, 4 * (_ROUNDS + 1)):
        temp = w[i - 1]
        if i % _KEY_WORDS == 0:
            temp = _sub_word(((temp << 8) | (temp >> 24)) & 0xFFFFFFFF) ^ (rcon << 24)
            rcon = _gmul(rcon, 2)
        elif i % _KEY_WORDS == 4:
            temp = _sub_word(temp)
        w.append(w[i - _KEY_WORDS] ^ temp)
    td0, td1, td2, td3 = _TD
    dk: List[int] = []
    for r in range(_ROUNDS, -1, -1):
        words = w[4 * r:4 * r + 4]
        if 0 < r < _ROUNDS:
            # InvMixColumns of a round key: the T-tables hold InvSubBytes,
            # which SubBytes here cancels
            words = [td0[_SBOX[x >> 24]] ^ td1[_SBOX[(x >> 16) & 0xFF]]
                     ^ td2[_SBOX[(x >> 8) & 0xFF]] ^ td3[_SBOX[x & 0xFF]]
                     for x in words]
        dk.extend(words)
    return w, dk


def _words(block: bytes) -> List[int]:
    return [int.from_bytes(block[i:i + 4], "big") for i in range(0, 16, 4)]


def _pack(words) -> bytes:
    return b"".join(x.to_bytes(4, "big") for x in words)


def _encrypt_block(s: List[int], rk: List[int]) -> List[int]:
    t0, t1, t2, t3 = _TE
    s0, s1, s2, s3 = (s[i] ^ rk[i] for i in range(4))
    k = 4
    for _ in range(_ROUNDS - 1):
        s0, s1, s2, s3 = (
            t0[s0 >> 24] ^ t1[(s1 >> 16) & 0xFF] ^ t2[(s2 >> 8) & 0xFF] ^ t3[s3 & 0xFF] ^ rk[k],
            t0[s1 >> 24] ^ t1[(s2 >> 16) & 0xFF] ^ t2[(s3 >> 8) & 0xFF] ^ t3[s0 & 0xFF] ^ rk[k + 1],
            t0[s2 >> 24] ^ t1[(s3 >> 16) & 0xFF] ^ t2[(s0 >> 8) & 0xFF] ^ t3[s1 & 0xFF] ^ rk[k + 2],
            t0[s3 >> 24] ^ t1[(s0 >> 16) & 0xFF] ^ t2[(s1 >> 8) & 0xFF] ^ t3[s2 & 0xFF] ^ rk[k + 3],
        )
        k += 4
    sb = _SBOX
    st = (s0, s1, s2, s3)
    return [
        ((sb[st[i] >> 24] << 24) | (sb[(st[(i + 1) % 4] >> 16) & 0xFF] << 16)
         | (sb[(st[(i + 2) % 4] >> 8) & 0xFF] << 8) | sb[st[(i + 3) % 4] & 0xFF])
        ^ rk[k + i]
        for i in range(4)
    ]


def _decrypt_block(s: List[int], dk: List[int]) -> List[int]:
    t0, t1, t2, t3 = _TD
    s0, s1, s2, s3 = (s[i] ^ dk[i] for i in range(4))
    k = 4
    for _ in range(_ROUNDS - 1):
        s0, s1, s2, s3 = (
            t0[s0 >> 24] ^ t1[(s3 >> 16) & 0xFF] ^ t2[(s2 >> 8) & 0xFF] ^ t3[s1 & 0xFF] ^ dk[k],
            t0[s1 >> 24] ^ t1[(s0 >> 16) & 0xFF] ^ t2[(s3 >> 8) & 0xFF] ^ t3[s2 & 0xFF] ^ dk[k + 1],
            t0[s2 >> 24] ^ t1[(s1 >> 16) & 0xFF] ^ t2[(s0 >> 8) & 0xFF] ^ t3[s3 & 0xFF] ^ dk[k + 2],
            t0[s3 >> 24] ^ t1[(s2 >> 16) & 0xFF] ^ t2[(s1 >> 8) & 0xFF] ^ t3[s0 & 0xFF] ^ dk[k + 3],
        )
        k += 4
    ib = _INV_SBOX
    st = (s0, s1, s2, s3)
    return [
        ((ib[st[i] >> 24] << 24) | (ib[(st[(i + 3) % 4] >> 16) & 0xFF] << 16)
         | (ib[(st[(i + 2) % 4] >> 8) & 0xFF] << 8) | ib[st[(i + 1) % 4] & 0xFF])
        ^ dk[k + i]
        for i in range(4)
    ]


def _check(key: bytes, iv: bytes, data: bytes) -> None:
    if len(iv) != BLOCK:
        raise ValueError(f"CBC takes a 16-byte IV, got {len(iv)}")
    if len(data) % BLOCK:
        raise ValueError("CBC input must be whole 16-byte blocks")


def cbc_encrypt(key: bytes, iv: bytes, plain: bytes) -> bytes:
    """AES-256-CBC of ``plain`` (whole blocks, already padded)."""
    _check(key, iv, plain)
    rk, _ = _expand(key)
    prev = _words(iv)
    out = []
    for i in range(0, len(plain), BLOCK):
        block = _words(plain[i:i + BLOCK])
        prev = _encrypt_block([b ^ p for b, p in zip(block, prev)], rk)
        out.append(_pack(prev))
    return b"".join(out)


def cbc_decrypt(key: bytes, iv: bytes, cipher: bytes) -> bytes:
    """The inverse of ``cbc_encrypt`` (the padding is left on)."""
    _check(key, iv, cipher)
    _, dk = _expand(key)
    prev = _words(iv)
    out = []
    for i in range(0, len(cipher), BLOCK):
        block = _words(cipher[i:i + BLOCK])
        plain = _decrypt_block(block, dk)
        out.append(_pack([p ^ v for p, v in zip(plain, prev)]))
        prev = block
    return b"".join(out)
