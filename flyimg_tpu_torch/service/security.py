"""Signed URLs and domain restrictions.

The port of ``flyimg_tpu/service/security.py``, wire-compatible with it and
with the reference's SecurityHandler: AES-256-CBC over
``"{options}/{imageSrc}"``, the key the first 32 characters of
sha256(security_key)'s hex digest as ASCII (PHP's ``openssl_encrypt`` takes
the first 32 bytes of the key string), the IV the first 16 characters of
sha256(security_iv)'s hex digest, PKCS#7 padding, and the cipher text
base64-encoded twice. A token either package mints decrypts in the other.
The cipher is the port's own (``service/aes.py``), so signed URLs need no
package the card machine lacks.

The handler calls ``check_security_hash`` and then
``check_restricted_domains`` before it parses any option.
"""

from __future__ import annotations

import base64
import hashlib
from typing import List, Tuple
from urllib.parse import urlparse

from flyimg_tpu_torch.exceptions import SecurityException
from flyimg_tpu_torch.service.aes import BLOCK, cbc_decrypt, cbc_encrypt


def _derive(security_key: str, security_iv: str) -> Tuple[bytes, bytes]:
    if not security_key:
        raise SecurityException("security_key is empty in parameters")
    key_hex = hashlib.sha256(security_key.encode()).hexdigest()
    iv_hex = hashlib.sha256(security_iv.encode()).hexdigest()[:16]
    return key_hex[:32].encode("ascii"), iv_hex.encode("ascii")


def encrypt(plain: str, security_key: str, security_iv: str) -> str:
    key, iv = _derive(security_key, security_iv)
    raw = plain.encode()
    pad = BLOCK - len(raw) % BLOCK
    cipher = cbc_encrypt(key, iv, raw + bytes([pad]) * pad)
    # openssl_encrypt answers base64, which the reference base64s again
    return base64.b64encode(base64.b64encode(cipher)).decode("ascii")


def decrypt(token: str, security_key: str, security_iv: str) -> str:
    """The plain text of a token, or "" for any token that does not
    decrypt to valid padding and UTF-8 (as the JAX package answers)."""
    key, iv = _derive(security_key, security_iv)
    try:
        raw = base64.b64decode(base64.b64decode(token, validate=False))
        if not raw or len(raw) % BLOCK:
            # the JAX package's cipher refuses a partial block: ""
            return ""
        padded = cbc_decrypt(key, iv, raw)
        pad = padded[-1]
        if not 1 <= pad <= 16:
            return ""
        return padded[:-pad].decode("utf-8")
    except Exception:
        return ""


class SecurityHandler:
    """The reference SecurityHandler's checks."""

    def __init__(self, params) -> None:
        self.params = params

    def check_restricted_domains(self, image_source: str) -> None:
        """With ``restricted_domains`` on and a ``whitelist_domains`` list,
        a source whose host is not listed answers 403."""
        if not self.params.by_key("restricted_domains"):
            return
        whitelist = self.params.by_key("whitelist_domains") or []
        if not isinstance(whitelist, list):
            return
        host = urlparse(image_source).hostname
        if host not in whitelist:
            raise SecurityException(
                "Restricted domains enabled, the domain your fetching from is "
                f"not allowed: {host}"
            )

    def check_security_hash(self, options: str, image_src: str) -> List[str]:
        """With a ``security_key`` set, the options path segment is the
        token: [options, imageSrc] decrypted from it (403 when it does not
        decrypt); without one, the segments as given."""
        security_key = self.params.by_key("security_key") or ""
        if not security_key:
            return [options, image_src]
        if not (self.params.by_key("security_iv") or ""):
            raise SecurityException(
                "Security iv is not set in parameters.yml (security_iv)"
            )
        decrypted = decrypt(
            options, security_key, self.params.by_key("security_iv") or ""
        )
        if not decrypted:
            raise SecurityException(
                "Security Key enabled: Requested URL doesn't match with the "
                "hashed Security key !"
            )
        parts = decrypted.split("/", 1)
        if len(parts) != 2 or not parts[0] or not parts[1]:
            raise SecurityException(
                f"Something went wrong when decrypting the hashed URL: {options}"
            )
        return [parts[0], parts[1]]

    def encrypt(self, text: str) -> str:
        return encrypt(
            text,
            self.params.by_key("security_key") or "",
            self.params.by_key("security_iv") or "",
        )

    def decrypt(self, token: str) -> str:
        return decrypt(
            token,
            self.params.by_key("security_key") or "",
            self.params.by_key("security_iv") or "",
        )
