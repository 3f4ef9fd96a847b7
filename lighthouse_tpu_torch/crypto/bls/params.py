"""BLS12-381 curve parameters.

These are the standard, publicly specified BLS12-381 constants (IETF RFC 9380 /
the Zcash BLS12-381 specification).  The reference client consumes them through
the `blst` library (reference: crypto/bls/src/impls/blst.rs); here they are
first-class Python integers so that both the pure-Python reference backend and
the PyTorch backend derive every other constant (Frobenius coefficients,
cofactors, Montgomery parameters) from this single module.

Derived quantities that the reference obtains from blst's precomputed tables
(the G1 cofactor) are *computed* from first principles and asserted, so
nothing here silently depends on a transcription.
"""

# Base field prime.
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

# Subgroup order (scalar field).
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# BLS parameter x (negative for BLS12-381).
X = -0xD201000000010000

# Curve: E(Fp): y^2 = x^3 + 4;  twist E'(Fp2): y^2 = x^3 + 4(u+1)  (M-twist).
B_G1 = 4
B_G2 = (4, 4)  # 4 * (1 + u)  as (c0, c1)

# Trace of Frobenius: #E(Fp) = P + 1 - T_FROB,  T_FROB = X + 1.
T_FROB = X + 1

# G1 cofactor: h1 = #E(Fp) / R  (asserted exact).
N_E1 = P + 1 - T_FROB
H1, _rem = divmod(N_E1, R)
assert _rem == 0, "G1 cofactor must divide the curve order exactly"
assert H1 == (X - 1) ** 2 // 3  # standard identity for BLS12 curves

# Hash-to-curve domain separation tag used by Ethereum consensus
# (reference: crypto/bls/src/impls/blst.rs:13).
DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

# Number of random bits in batch-verification weights
# (reference: crypto/bls/src/impls/blst.rs:14).
RAND_BITS = 64

# Generator of G1 (standard).
G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)

# Generator of G2 (standard), coordinates in Fp2 as (c0, c1).
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

# Serialized sizes (Zcash encoding, used by the whole Ethereum ecosystem).
G1_COMPRESSED_BYTES = 48
G2_COMPRESSED_BYTES = 96
SCALAR_BYTES = 32
