"""Entry points of a model of the zoo (``repro.launch``): the serve path
(``serve``) and the pod FL train step (``train``)."""
