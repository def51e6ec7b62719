"""Tools of the port that run on the card: the recipes' chains
(``e2e_chain``), the recognition proxy (``proxy_asr``) and the kernels'
timing tools."""
