"""Trust-weighted bit voting kernels (host numpy; the port's copy of
``pycusdr_tpu/combine/votes.py``).

Semantics parity with the reference vote routines
(``softCombiner.py:570-662``): bits whose trust is negative are
disqualified; the master channel's vote is scaled by
``masterVoteWeight`` so ties break its way; the 2-way vote resolves
disagreements by trust with the reference's fixed trust constants.
Both are fully vectorised (the reference's 2-way path loops in Python
over every disagreeing bit).
"""

import numpy as np

from pycusdr_tpu_torch.globals import DATATYPE

# trust codes for 2-way disagreements (reference softCombiner.py:40-43)
BOTH_TRUST_ERR = 0.1  # both trust their bit but disagree -> master wins
MASTER_TRUST = 0.7  # slave disqualified -> master wins
SLAVE_TRUST = 0.3  # master disqualified -> slave wins
BOTH_DISTRUST = -1.0  # both disqualified


def do_voteN(bitsM, trustM, bitsS, trustS, masterVoteWeight: float = 1.2):
    """N-way weighted majority vote (reference ``_doVoteN``,
    softCombiner.py:570-618).

    bitsM/trustM: (n,) master arrays; bitsS/trustS: lists of (n,) slave
    arrays. Returns (bits DATATYPE[n], trust float[n]) where trust
    encodes ``votersAgreed + qualifiedVoters/10``.
    """
    bits = np.vstack([np.asarray(bitsM, float) * masterVoteWeight,
                      np.asarray(bitsS, float)])
    trust = np.vstack([trustM, np.asarray(trustS)])

    qualified = trust >= 0
    votes = np.where(qualified, bits, 0.0)

    # threshold = half the total qualified vote weight, so a tie goes to
    # the master and a strict weighted majority always wins. (The
    # reference adds masterVoteWeight/2 ON TOP of counting the master as
    # a full voter, softCombiner.py:599-600 — with 2 slaves that makes a
    # wrong master unbeatable; this is the intended fix.)
    weights = np.ones((bits.shape[0], 1))
    weights[0, 0] = masterVoteWeight
    threshold = (qualified * weights).sum(axis=0) / 2.0

    bVal = votes.sum(axis=0)
    bitsT = (bVal > threshold).astype(DATATYPE)

    # trust = agreed.quorum: integer part counts qualified voters that
    # agree with the outcome, fractional part encodes the quorum size
    raw = np.vstack([bitsM, bitsS])
    agreed = (qualified & (raw == bitsT[None, :])).sum(axis=0)
    quorum = qualified.sum(axis=0)
    trustT = agreed + quorum / 10.0
    trustT[quorum == 0] = BOTH_DISTRUST
    return bitsT, trustT


def do_vote2(bitsM, trustM, bitsS, trustS):
    """2-way vote, master favoured (reference ``_doVote2``,
    softCombiner.py:620-660).

    Bit selection matches the reference exactly, including the edge
    case where the master is disqualified and the slave sits at
    trust == 0: the slave is only adopted at strictly positive trust
    (``trustS > 0``, softCombiner.py:651); at trustS == 0 the bit
    stays at the halved sum (0 for any disagreement) with agreement
    trust, exactly as the reference leaves it.

    DELIBERATE DEVIATION — trust sign convention: the reference
    returns ``-trustV`` (softCombiner.py:660), making *good* bits
    negative on the wire, while its own N-way vote returns positive
    trust and every consumer in this pipeline (CCSDS soft-decision
    preprocessor, clip tagging at trust −2, ``do_voteN``) treats
    ``trust < 0`` as "erase this bit". Propagating the reference's
    negation would erase every high-confidence bit of a 2-channel
    vote group at the decoder. We therefore return the trust codes
    un-negated: agreement → +1, resolved disagreements →
    +0.1/+0.7/+0.3, both-distrust → −1. The mapping to the
    reference's wire values is ``trust_ref = -trust_here`` and is
    regression-pinned in tests/test_combine.py.
    """
    bitsM = np.asarray(bitsM)
    bitsS = np.asarray(bitsS)
    trustM = np.asarray(trustM)
    trustS = np.asarray(trustS)

    agree = bitsM == bitsS
    slave_bad = trustS < 0
    master_bad = trustM < 0

    # reference default for a disagreement: the halved sum, which is
    # always 0 for {0,1} bits (softCombiner.py:631)
    halved = ((bitsM + bitsS) // 2).astype(DATATYPE)

    # branch order mirrors softCombiner.py:640-657
    use_master = slave_bad | (~master_bad)  # trustS<0 branch or final else
    use_slave = ~slave_bad & master_bad & (trustS > 0)
    bitsV = np.where(use_master, bitsM, halved)
    bitsV = np.where(use_slave, bitsS, bitsV)
    bitsV = np.where(agree, bitsM, bitsV).astype(DATATYPE)

    trustV = np.ones(len(bitsM))
    trustV = np.where(~agree & slave_bad & master_bad, BOTH_DISTRUST, trustV)
    trustV = np.where(~agree & slave_bad & ~master_bad, MASTER_TRUST, trustV)
    trustV = np.where(~agree & use_slave, SLAVE_TRUST, trustV)
    trustV = np.where(~agree & ~slave_bad & ~master_bad, BOTH_TRUST_ERR, trustV)
    return bitsV, trustV
