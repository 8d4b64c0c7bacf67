"""The aligner's algorithms beside banded NW: Myers scoring with a banded
re-run, score-free banded escalation, and Hirschberg's divide and conquer."""
