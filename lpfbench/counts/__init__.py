"""The benchmark's yardstick arithmetic: the card's peaks, and the
operations, bytes and least times of the work a cell does, computed from
shapes alone.  Frozen copies: later changes to the program do not move
them."""
