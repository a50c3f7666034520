"""Runtime on one device: the train- and serve-step builders
(:mod:`.train_step`), the supervised training loop (:mod:`.train_loop`),
the hardened continuous-batching serve loop (:mod:`.server`) and the
straggler monitor (:mod:`.monitor`)."""
