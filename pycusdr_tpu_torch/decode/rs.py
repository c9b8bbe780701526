"""Reed-Solomon FEC codec over GF(2^8) (the port's verbatim copy of
``pycusdr_tpu/decode/rs.py``).

The reference advertises Reed-Solomon support via the external
``pyreedsolomon`` package (``README.md:4``; no RS call exists inside the
reference repo itself). This is a self-contained implementation so the
TPU framework carries the capability natively: systematic RS(n, k)
encode, and decode with error correction up to t = (n-k)/2 symbols
(Berlekamp–Massey + Chien search + Forney algorithm).

Defaults match the classic CCSDS/CC11xx-adjacent RS(255, 223)
with primitive polynomial x^8+x^4+x^3+x^2+1 (0x11D).
"""

import numpy as np


class RSError(ValueError):
    """Uncorrectable codeword."""


class _GF256:
    def __init__(self, prim_poly: int = 0x11D, generator: int = 2):
        self.exp = np.zeros(512, dtype=np.int64)
        self.log = np.zeros(256, dtype=np.int64)
        x = 1
        for i in range(255):
            self.exp[i] = x
            self.log[x] = i
            x <<= 1
            if x & 0x100:
                x ^= prim_poly
        self.exp[255:510] = self.exp[:255]

    def mul(self, a, b):
        if a == 0 or b == 0:
            return 0
        return int(self.exp[self.log[a] + self.log[b]])

    def div(self, a, b):
        if b == 0:
            raise ZeroDivisionError
        if a == 0:
            return 0
        return int(self.exp[(self.log[a] - self.log[b]) % 255])

    def inv(self, a):
        return int(self.exp[255 - self.log[a]]) if a else 0

    def poly_mul(self, p, q):
        out = [0] * (len(p) + len(q) - 1)
        for i, pi in enumerate(p):
            if pi == 0:
                continue
            for j, qj in enumerate(q):
                if qj:
                    out[i + j] ^= self.mul(pi, qj)
        return out

    def poly_eval(self, p, x):
        """Evaluate polynomial (highest degree first) at x via Horner."""
        y = 0
        for c in p:
            y = self.mul(y, x) ^ c
        return y


class RSCodec:
    """Systematic RS(n, k) over GF(256)."""

    def __init__(self, n: int = 255, k: int = 223, prim_poly: int = 0x11D, fcr: int = 1):
        if not (0 < k < n <= 255):
            raise ValueError("require 0 < k < n <= 255")
        self.n = n
        self.k = k
        self.nsym = n - k
        self.t = self.nsym // 2
        self.fcr = fcr
        self.gf = _GF256(prim_poly)

        # generator polynomial g(x) = prod_{i=0}^{nsym-1} (x - a^(fcr+i))
        g = [1]
        for i in range(self.nsym):
            g = self.gf.poly_mul(g, [1, self.gf.exp[(fcr + i) % 255]])
        self.gen = g

    # ---------------- encode ----------------

    def encode(self, msg) -> np.ndarray:
        """Append nsym parity symbols (systematic)."""
        msg = np.asarray(msg, dtype=np.int64)
        if len(msg) != self.k:
            raise ValueError(f"message must be k={self.k} symbols, got {len(msg)}")
        rem = list(msg) + [0] * self.nsym
        for i in range(self.k):
            coef = rem[i]
            if coef:
                for j in range(1, len(self.gen)):
                    rem[i + j] ^= self.gf.mul(self.gen[j], coef)
        return np.r_[msg, np.array(rem[self.k :], dtype=np.int64)].astype(np.uint8)

    # ---------------- decode ----------------

    def _syndromes(self, cw):
        return [self.gf.poly_eval(cw, self.gf.exp[(self.fcr + i) % 255]) for i in range(self.nsym)]

    def decode(self, codeword):
        """Return (corrected message, n_errors). Raises RSError if
        uncorrectable."""
        cw = list(np.asarray(codeword, dtype=np.int64))
        if len(cw) != self.n:
            raise ValueError(f"codeword must be n={self.n} symbols")

        synd = self._syndromes(cw)
        if max(synd) == 0:
            return np.array(cw[: self.k], dtype=np.uint8), 0

        # Berlekamp–Massey: find error locator sigma(x)
        sigma = [1]
        prev = [1]
        L, m, b = 0, 1, 1
        for i in range(self.nsym):
            d = synd[i]
            for j in range(1, L + 1):
                if j < len(sigma):
                    d ^= self.gf.mul(sigma[j], synd[i - j])
            if d == 0:
                m += 1
            elif 2 * L <= i:
                tmp = sigma[:]
                coef = self.gf.mul(d, self.gf.inv(b))
                shifted = [0] * m + prev
                scaled = [self.gf.mul(coef, c) for c in shifted]
                sigma = [
                    (sigma[j] if j < len(sigma) else 0) ^ (scaled[j] if j < len(scaled) else 0)
                    for j in range(max(len(sigma), len(scaled)))
                ]
                L = i + 1 - L
                prev = tmp
                b = d
                m = 1
            else:
                coef = self.gf.mul(d, self.gf.inv(b))
                shifted = [0] * m + prev
                scaled = [self.gf.mul(coef, c) for c in shifted]
                sigma = [
                    (sigma[j] if j < len(sigma) else 0) ^ (scaled[j] if j < len(scaled) else 0)
                    for j in range(max(len(sigma), len(scaled)))
                ]
                m += 1

        n_err = L
        if n_err > self.t:
            raise RSError(f"too many errors ({n_err} > t={self.t})")

        # Chien search over valid positions
        err_pos = []
        for pos in range(self.n):
            # error at position pos (0 = first symbol) has locator a^(n-1-pos)
            x_inv = self.gf.exp[(255 - (self.n - 1 - pos)) % 255]
            val = 0
            for j, c in enumerate(sigma):
                val ^= self.gf.mul(c, self.gf.exp[(self.gf.log[x_inv] * j) % 255]) if c else 0
            if val == 0:
                err_pos.append(pos)
        if len(err_pos) != n_err:
            raise RSError("error locator degree mismatch (uncorrectable)")

        # Forney: error magnitudes
        # omega(x) = [S(x) * sigma(x)] mod x^nsym  (S in increasing powers)
        s_poly = synd  # S_1..S_nsym, increasing power order
        omega = [0] * self.nsym
        for i in range(self.nsym):
            acc = 0
            for j in range(min(i + 1, len(sigma))):
                acc ^= self.gf.mul(sigma[j], s_poly[i - j])
            omega[i] = acc

        sigma_deriv = [c if (j % 2 == 1) else 0 for j, c in enumerate(sigma)][1:]
        # formal derivative: keep odd-power coefficients shifted down one

        for pos in err_pos:
            x = self.gf.exp[(self.n - 1 - pos) % 255]  # locator X_i
            x_inv = self.gf.inv(x)
            # omega(X^-1) with omega in increasing powers
            om = 0
            for j, c in enumerate(omega):
                om ^= self.gf.mul(c, self.gf.exp[(self.gf.log[x_inv] * j) % 255]) if c else 0
            # sigma'(X^-1)
            sd = 0
            for j, c in enumerate(sigma_deriv):
                sd ^= self.gf.mul(c, self.gf.exp[(self.gf.log[x_inv] * j) % 255]) if c else 0
            if sd == 0:
                raise RSError("Forney derivative zero (uncorrectable)")
            mag = self.gf.mul(self.gf.exp[(self.gf.log[x] * (1 - self.fcr)) % 255], self.gf.div(om, sd))
            cw[pos] ^= mag

        if max(self._syndromes(cw)) != 0:
            raise RSError("correction failed (residual syndromes)")
        return np.array(cw[: self.k], dtype=np.uint8), n_err
