"""Counter-based random numbers for reproducible stochastic physics.

The reference uses random123 (Philox) keyed on (stream id, seed, timestep)
with per-particle or per-pair counters so that every rank of an MPI job
draws identical noise without communication
(/root/reference/src/DPDPairEvaluatorGeneralWeight.h:227-231,
/root/reference/src/RNGIdentifiers.h:20-27). This engine keeps the same
discipline with a vectorized Threefry-2x32 implemented directly in jnp
integer ops: pure elementwise math, no state, bitwise identical regardless of
sharding or device count.

Streams mirror the reference identifiers.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "Stream",
    "threefry2x32",
    "uniform_from_bits",
    "pair_uniform",
    "particle_uniform3",
    "particle_bits",
]


class Stream:
    """RNG stream identifiers (mirrors /root/reference/src/RNGIdentifiers.h:20-27)."""

    DPD_GENERAL_WEIGHT = 200
    BROWNIAN_FLOW = 201
    LANGEVIN_FLOW = 202
    PARTICLE_EVAPORATOR = 203
    # new streams for this engine's own integrators
    LANGEVIN = 210
    BROWNIAN = 211
    THERMALIZE = 212
    LANGEVIN_ANGULAR = 213
    THERMALIZE_ANGULAR = 214


def _rotl32(x, r):
    return (x << jnp.uint32(r)) | (x >> jnp.uint32(32 - r))


# Threefry-2x32 rotation schedule (Salmon et al., SC'11).
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
# plain int, materialized inside each trace (a module-level device
# array would be a captured constant of every trace)
_PARITY = 0x1BD11BDA
# Crush-resistant minimum round count for Threefry-2x32 (Salmon et al.
# SC'11 Table 2) — used by the hot per-pair DPD noise paths.
FAST_ROUNDS = 13


def threefry2x32(k0, k1, c0, c1, rounds: int = 20):
    """Threefry-2x32 block cipher (random123 round/injection schedule).

    All arguments are uint32 arrays (broadcast together). Returns two
    uint32 arrays of the broadcast shape. This is straight-line elementwise
    integer math and vectorizes over millions of counters per step.

    ``rounds`` follows the random123 convention: a key injection after
    every 4th round (never after a trailing partial group). The default
    20 matches jax.random's Threefry-2x32 and carries a 7-round safety
    margin over the 13 rounds Salmon et al. (SC'11, Table 2) measured as
    the BigCrush-passing minimum. Hot per-pair noise paths (DPD) use
    ``rounds=FAST_ROUNDS`` (13) — the same margin policy as the
    reference's own Philox4x32-10 (Crush minimum 7 + 3 margin;
    /root/reference/src/DPDPairEvaluatorGeneralWeight.h:227-231 via
    hoomd RandomGenerator).
    """
    k0 = jnp.asarray(k0, dtype=jnp.uint32)
    k1 = jnp.asarray(k1, dtype=jnp.uint32)
    x0 = jnp.asarray(c0, dtype=jnp.uint32) + k0
    x1 = jnp.asarray(c1, dtype=jnp.uint32) + k1
    k2 = k0 ^ k1 ^ jnp.uint32(_PARITY)
    ks = (k0, k1, k2)

    for i in range(rounds):
        x0 = x0 + x1
        x1 = _rotl32(x1, _ROTATIONS[i % 8]) ^ x0
        if i % 4 == 3:
            inject = i // 4 + 1
            x0 = x0 + ks[inject % 3]
            x1 = x1 + ks[(inject + 1) % 3] + jnp.uint32(inject)
    return x0, x1


def uniform_from_bits(bits, low=-1.0, high=1.0):
    """Map uint32 bits to a float32 uniform in [low, high).

    Uses the mantissa-fill trick: 23 random mantissa bits with exponent 0
    give [1, 2), shifted to [0, 1).
    """
    mantissa = bits >> jnp.uint32(9)
    one = jnp.uint32(0x3F800000)
    f = jnp.bitwise_or(one, mantissa).view(jnp.float32) - jnp.float32(1.0)
    return f * (high - low) + low


def _key_words(stream: int, seed, timestep):
    """Build the two key words from (stream id, user seed, timestep)."""
    seed = jnp.asarray(seed, dtype=jnp.uint32)
    timestep = jnp.asarray(timestep, dtype=jnp.uint32)
    k0 = (jnp.uint32(stream) << jnp.uint32(16)) ^ seed
    k1 = timestep
    return k0, k1


def pair_uniform(
    stream: int, seed, timestep, tag_a, tag_b, low=-1.0, high=1.0,
    rounds: int = 20,
):
    """One uniform per pair, symmetric in (tag_a, tag_b).

    The tags are sorted so both owners of a pair draw the same number —
    the property the reference enforces at
    /root/reference/src/DPDPairEvaluatorGeneralWeight.h:213-231. Hot
    per-pair paths (DPD thermostat noise) pass ``rounds=FAST_ROUNDS``.
    """
    tag_a = jnp.asarray(tag_a, dtype=jnp.uint32)
    tag_b = jnp.asarray(tag_b, dtype=jnp.uint32)
    lo = jnp.minimum(tag_a, tag_b)
    hi = jnp.maximum(tag_a, tag_b)
    k0, k1 = _key_words(stream, seed, timestep)
    x0, _ = threefry2x32(k0, k1, lo, hi, rounds=rounds)
    return uniform_from_bits(x0, low, high)


def particle_bits(stream: int, seed, timestep, tag, n_words: int = 4):
    """n_words uint32 streams keyed per particle tag. Returns a tuple."""
    tag = jnp.asarray(tag, dtype=jnp.uint32)
    k0, k1 = _key_words(stream, seed, timestep)
    words = []
    lane = 0
    while len(words) < n_words:
        x0, x1 = threefry2x32(k0, k1, tag, jnp.uint32(lane))
        words.extend([x0, x1])
        lane += 1
    return tuple(words[:n_words])


def particle_uniform3(stream: int, seed, timestep, tag, low=-1.0, high=1.0):
    """Three i.i.d. uniforms per particle, shape ``tag.shape + (3,)``."""
    w0, w1, w2, _ = particle_bits(stream, seed, timestep, tag, n_words=4)
    u = jnp.stack(
        [
            uniform_from_bits(w0, low, high),
            uniform_from_bits(w1, low, high),
            uniform_from_bits(w2, low, high),
        ],
        axis=-1,
    )
    return u
