"""Dataset generators and readers (host side, numpy)."""
