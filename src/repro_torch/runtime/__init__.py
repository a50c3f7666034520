"""Serving runtime on one device: the hardened continuous-batching serve
loop (:mod:`.server`), the straggler monitor (:mod:`.monitor`) and the
serving half of the step builders (:mod:`.train_step`)."""
