"""The benchmark's yardstick: the collection generator, the plain
reference (exact inner products and top-k), the bytes and operations
each kernel must move, and the H100's published peaks. Imports nothing
of the program."""
