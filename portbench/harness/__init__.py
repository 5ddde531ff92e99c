"""The benchmark's harness: cells and their files (:mod:`.cells`),
weights and batches made from the seed (:mod:`.inputs`), the training
cells' set-up, window and check (:mod:`.train`), the profiler's reading
(:mod:`.trace`) and the comparison that decides ``correct``
(:mod:`.compare`)."""
