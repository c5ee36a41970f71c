"""Operations and bytes of the work, counted once from shapes, whatever
implements it: the algorithm's needs, not what a kernel happens to do."""
