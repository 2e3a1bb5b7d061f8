"""Mean per job of the ``run/extension_rounds`` counter in the job's
``metrics.json``: rounds the extension loop ran to its fixpoint."""


def read(ctx):
    return ctx.mean_counter("run/extension_rounds")
