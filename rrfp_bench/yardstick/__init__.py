"""The benchmark's frozen arithmetic: FLOP and byte counts, peaks, kernel
categories."""
