"""The port's entry points: ``python -m multimodal_rssm_torch.cli.<name>``,
and the ``mrssm-torch-*`` console scripts of ``pyproject.toml``, each the
``main`` of the module of its name."""

import functools


def command(main):
    """``main(argv)`` fit for a console script, which exits with
    ``sys.exit(main())``: read from the command line (``argv`` None), it
    returns only an exit status (an int; otherwise None, status 0), where a
    dict or a path would be printed and exit 1.  A caller that passes
    ``argv`` gets the result itself."""

    @functools.wraps(main)
    def entry(argv=None):
        result = main(argv)
        if argv is None and not isinstance(result, int):
            return None
        return result

    return entry
