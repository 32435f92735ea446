"""The benchmark's own library: the yardstick that later changes to the
program cannot move (input generation, the plain reference and its
comparison, the peaks, the trace arithmetic, the import guard)."""
