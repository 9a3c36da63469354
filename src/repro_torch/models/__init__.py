"""The LM stack of the dense and hybrid families (Granite, Qwen, Hymba):
layers, attention, the SSM heads, the decoder and its decode cache."""
