"""Status codes and alignment-state enums (copy of
``claragenomicsanalysis_tpu/core/status.py``, the parts the port runs).

A batch never hard-fails because one problem overflowed a limit: the problem
gets a status code and the rest of the batch proceeds.  The values are those
of the JAX package, so results compare across the two packages.
"""

import enum


class StatusType(enum.IntEnum):
    """Per-problem status."""

    SUCCESS = 0
    UNINITIALIZED = 1
    GENERIC_ERROR = 2
    # aligner
    EXCEEDED_MAX_ALIGNMENTS = 10
    EXCEEDED_MAX_LENGTH = 11
    EXCEEDED_MAX_ALIGNMENT_DIFFERENCE = 12  # band overflow (banded NW)
    # poa
    EXCEEDED_MAXIMUM_POAS = 20
    EXCEEDED_MAXIMUM_SEQUENCE_SIZE = 21
    EXCEEDED_MAXIMUM_SEQUENCES_PER_POA = 22
    NODE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE = 23
    EDGE_COUNT_EXCEEDED_MAXIMUM_GRAPH_SIZE = 24
    SEQ_LEN_EXCEEDED_MAXIMUM_NODES = 25
    LOOP_COUNT_EXCEEDED_UPPER_BOUND = 26
    OUTPUT_TYPE_UNAVAILABLE = 27
    EXCEEDED_BAND_WIDTH = 28  # banded graph-NW: no global path inside band
    # mapper
    EXCEEDED_MAX_ANCHORS = 30
    EXCEEDED_MAX_OVERLAPS = 31


class AlignmentType(enum.IntEnum):
    GLOBAL_ALIGNMENT = 0


class AlignmentState(enum.IntEnum):
    """Edit-path op codes, used for traceback arrays and CIGAR conversion.

    The *query* is aligned against the *target* (SAM orientation):
    INSERTION consumes a query base, DELETION consumes a target base.  Every
    NW implementation breaks ties the same way: MATCH/MISMATCH (diagonal),
    then DELETION, then INSERTION.
    """

    MATCH = 0
    MISMATCH = 1
    INSERTION = 2   # consumes query
    DELETION = 3    # consumes target


class OutputType(enum.IntFlag):
    """POA batch output selection."""

    CONSENSUS = 1
    MSA = 2


#: CIGAR op letter per AlignmentState in compact (M/I/D) form: match and
#: mismatch both fold into 'M'
CIGAR_OP_COMPACT = {0: "M", 1: "M", 2: "I", 3: "D"}
#: Extended (=/X/I/D) form.
CIGAR_OP_EXTENDED = {0: "=", 1: "X", 2: "I", 3: "D"}
