"""Decoder-only transformers with GQA attention and dense or routed
SwiGLU MLPs (softmax top-k routing renormalised over the chosen experts,
shared experts, a capacity a group): mistral-nemo-12b."""
