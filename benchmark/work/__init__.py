"""The yardstick of the roofline shares: the operations and bytes of one
substep of work of each configuration kind, counted from shapes, and the
card's published peaks (``peaks``). Frozen here, so that later changes to
the program cannot move them."""
