"""The native host core of the port's RPC layer: ``build.py`` compiles
``src/cc`` into ``build/torch_core/`` at first use, ``lib.py`` binds
it.  Importing this package builds and loads nothing."""
