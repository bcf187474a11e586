"""Gang rendezvous: the pure ownership rule the port uses so far.

Counterpart of ``dmlc_tpu/rendezvous``. Ported: :mod:`.elastic`'s
``content_owner`` (with ``owner_of``), the rule that maps a remote
checkpoint's content-addressed page to the rank that fetches it. The
rendezvous service, its client and the elastic resharding plan are not
ported yet.
"""
